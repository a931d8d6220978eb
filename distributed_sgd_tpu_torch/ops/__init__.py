"""Sparse ops: plain torch gather/scatter and the worker-gradient kernel."""
