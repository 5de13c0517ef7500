"""Serving: bundle export/load, the dynamic-batching engine, the
continuous-batching scheduler with its session tier, streaming generation
and the HTTP front end (paddle_tpu/serve)."""

from paddle_tpu_torch.serve.bundle import Bundle, load_bundle, pad_rows
from paddle_tpu_torch.serve.engine import InferenceEngine, Overloaded
from paddle_tpu_torch.serve.export import export_bundle
from paddle_tpu_torch.serve.generate import generate
from paddle_tpu_torch.serve.scheduler import ContinuousScheduler
from paddle_tpu_torch.serve.server import make_server, serve_in_thread
from paddle_tpu_torch.serve.sessions import SessionGone, SessionStore
