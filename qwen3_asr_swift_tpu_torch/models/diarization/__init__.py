"""Speaker diarization pipeline + DER scoring."""

from .pipeline import (  # noqa: F401
    DiarizationConfig,
    DiarizationPipeline,
    agglomerative_cluster,
    diarization_error_rate,
)
from .sortformer import (  # noqa: F401
    CONFIG_SORTFORMER,
    SortformerConfig,
    SortformerDiarizer,
)
