from infinitensor_tpu_torch.serving.kvcache import (
    clone_kv_slot, clear_kv_slot, write_prefill_into_slot,
)
from infinitensor_tpu_torch.serving.engine import ServingEngine, Request
from infinitensor_tpu_torch.serving.paged_engine import PagedServingEngine
from infinitensor_tpu_torch.serving.speculative import (
    ModelDraft, PromptLookupDraft, speculative_generate,
)

__all__ = ["ServingEngine", "PagedServingEngine", "Request",
           "clone_kv_slot", "clear_kv_slot", "write_prefill_into_slot",
           "speculative_generate", "ModelDraft", "PromptLookupDraft"]
