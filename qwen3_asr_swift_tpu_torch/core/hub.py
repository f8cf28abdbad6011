"""Model directories — the local half of ``qwen3_asr_swift_tpu/core/hub.py``.

A model id that names a directory on disk is used as it is, as the
reference's ``download_weights`` passes local directories through. Hub
download is not ported: any other id raises.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional


def download_weights(model_id: str, cache_dir: Optional[str] = None,
                     offline_mode: bool = False, **kwargs) -> Path:
    """``model_id`` as a local directory; raises ``FileNotFoundError`` for
    anything else (hub download is not ported)."""
    as_path = Path(model_id)
    if as_path.is_dir():
        return as_path
    raise FileNotFoundError(
        f"{model_id!r} is not a local directory, and hub download is not ported: "
        f"pass the directory of a checkpoint")
