"""Model layers, GQA attention and the decoder stack (``repro.models``)."""
