"""Serving: the engine and the continuous batcher (``repro.serve``)."""
