"""Speaker diarization pipeline + DER scoring. ``SortformerDiarizer``
comes with Parakeet's encoder (ROADMAP §1 item 5)."""

from .pipeline import (  # noqa: F401
    DiarizationConfig,
    DiarizationPipeline,
    agglomerative_cluster,
    diarization_error_rate,
)
