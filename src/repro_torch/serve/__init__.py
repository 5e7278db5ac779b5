"""Paged continuous-batching serving of the port (``repro.serve``)."""
