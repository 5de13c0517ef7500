"""`paddle.trainer` compat namespace (reference: python/paddle/trainer)."""
