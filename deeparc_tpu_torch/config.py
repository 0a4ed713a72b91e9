"""Option dataclasses, shared with the reference package (plain Python:
``SolverOptions``, ``FilterOptions``, ``PipelineOptions``)."""

from deeparc_tpu.config import FilterOptions, PipelineOptions, SolverOptions

__all__ = ["FilterOptions", "PipelineOptions", "SolverOptions"]
