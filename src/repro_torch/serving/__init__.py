"""Elastic LLM serving tier on the VSN slot pool.

Held against ``src/repro/serving``.  ``kv_pool`` holds the continuous-
batching engine and the slot pool whose ownership table is the paper's
``f_mu``; ``stream`` makes the engine a stream operator (requests as
tuples, an ``AsyncStreamRuntime``/``IngestTier`` compatible pipeline, an
SLO-driven controller policy).
"""

from repro_torch.serving.kv_pool import (Request, ServingEngine, SlotPool,
                                         reference_decode)
from repro_torch.serving.stream import (RequestSource, ServingConfig,
                                        ServingPipeline,
                                        SloServingController,
                                        build_serving_pipeline)

__all__ = [
    "Request", "ServingEngine", "SlotPool", "reference_decode",
    "RequestSource", "ServingConfig", "ServingPipeline",
    "SloServingController", "build_serving_pipeline",
]
