"""HPC solvers on the emulated kernel stack."""
