"""AdamW and learning-rate schedules (``repro.optim``)."""
