"""Serving: bundle export/load, the dynamic-batching engine, the
continuous-batching scheduler with its session tier, streaming generation
and the HTTP front end (paddle_tpu/serve).

The import split is the JAX package's: this module and everything
``load_bundle`` reaches stay free of the graph machinery, and
``export_bundle`` / ``verify_bundle`` (which build the graph) load on
first use.
"""

from paddle_tpu_torch.serve.bundle import (Bundle, is_bundle, load_bundle,
                                           pad_rows)
from paddle_tpu_torch.serve.engine import InferenceEngine, Overloaded
from paddle_tpu_torch.serve.generate import generate
from paddle_tpu_torch.serve.scheduler import ContinuousScheduler
from paddle_tpu_torch.serve.server import make_server, serve_in_thread
from paddle_tpu_torch.serve.sessions import SessionGone, SessionStore


def __getattr__(name):
    if name in ("export_bundle", "verify_bundle"):
        from paddle_tpu_torch.serve import export as _export

        return getattr(_export, name)
    raise AttributeError("module 'paddle_tpu_torch.serve' has no attribute "
                         "%r" % name)
