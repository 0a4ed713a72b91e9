"""The benchmark of ``deeparc_tpu_torch`` on one NVIDIA H100: timed solves
and pipelines of generated scenes, judged against a plain reference
(``README.md``)."""
