"""The port's serving layer (``raft_tpu/serve`` without its network
tier): shape buckets (:mod:`.buckets`), the warm-up manifest and prep
cache (:mod:`.cache`), the exact-answer result cache
(:mod:`.result_cache`) and the micro-batching :class:`Engine`
(:mod:`.engine`).  The wire schema, the HTTP transport, the router and
the autoscaler wait for ROADMAP.md queue 1 step 12b.
"""

from raft_tpu_torch.serve.buckets import (  # noqa: F401
    BucketSpec,
    SlotPhysics,
    bucket_shapes,
    choose_bucket,
    compile_bucket,
    dispatch_slots,
    pack_slots,
    pad_nodes,
    slot_pipeline,
    slotted_case_dispatch,
)
from raft_tpu_torch.serve.cache import (  # noqa: F401
    CompileWatcher,
    PrepCache,
    WarmupManifest,
    current_flags,
    design_prep_key,
    flags_mismatch,
    warmup,
)
from raft_tpu_torch.serve.engine import (  # noqa: F401
    TERMINAL_STATUSES,
    Engine,
    EngineConfig,
    GradResult,
    Request,
    RequestResult,
    SweepHandle,
    SweepResult,
)
from raft_tpu_torch.serve.result_cache import (  # noqa: F401
    ResultCache,
    result_key,
    routing_key,
)
