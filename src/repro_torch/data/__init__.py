"""The synthetic token pipeline (``repro.data``)."""
