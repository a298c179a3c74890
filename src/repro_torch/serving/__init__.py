"""Serving engines of the port: ``LookupEngine``, the paper's
encode-once / look-up-many memory serving (``lookup_engine.py``)."""

from repro_torch.serving.lookup_engine import (  # noqa: F401
    LookupEngine, get_lookup_backend, register_lookup_backend,
)
