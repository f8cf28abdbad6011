"""Process mesh + sharding (dp/tp over torch.distributed; window-dim
sequence parallelism) — port of ``qwen3_asr_swift_tpu/parallel``."""

from .launch import spawn  # noqa: F401
from .mesh import (  # noqa: F401
    PERSONAPLEX_RULES,
    QWEN3_DECODER_RULES,
    QWEN3_ENCODER_RULES,
    Mesh,
    batch_sharding,
    init_distributed,
    make_mesh,
    replicate,
    shard_pytree,
    sharded,
)
