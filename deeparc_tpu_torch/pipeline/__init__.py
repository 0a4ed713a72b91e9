from deeparc_tpu_torch.pipeline.driver import PipelineResult, run_pipeline

__all__ = ["PipelineResult", "run_pipeline"]
