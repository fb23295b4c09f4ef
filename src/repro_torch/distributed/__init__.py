"""Distributed training pieces (``repro.distributed``): so far the int8
error-feedback gradient compressor, which has no collective."""
