"""The port's serving layer (``raft_tpu/serve``): shape buckets
(:mod:`.buckets`), the warm-up manifest and prep cache (:mod:`.cache`),
the exact-answer result cache (:mod:`.result_cache`), the micro-batching
:class:`Engine` (:mod:`.engine`), and the network tier: the wire schema
(:mod:`.wire`), the HTTP transport (:mod:`.transport`), the replica
:class:`Router` (:mod:`.router`) and its autoscaler (:mod:`.autoscale`).
"""

from raft_tpu_torch.serve.autoscale import (  # noqa: F401
    AutoscaleConfig,
    Autoscaler,
)
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
from raft_tpu_torch.serve.router import (  # noqa: F401
    HandshakeRefused,
    HashRing,
    Router,
    spawn_replica,
)
from raft_tpu_torch.serve.transport import (  # noqa: F401
    ConnectionDropped,
    HttpTransport,
    WireChecksumError,
    WireClient,
    serve_http,
)
