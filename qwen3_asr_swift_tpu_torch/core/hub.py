"""HuggingFace model cache with retry / offline / hardening.

TPU-native analog of the reference's downloader
(reference: Sources/AudioCommon/HuggingFaceDownloader.swift:24-277):
- snapshot download with glob patterns
- 3-attempt retry with 0/5/15 s backoff
- offline short-circuit (uses cache, errors if missing)
- path-traversal hardening on remote file names
- cache dir ``~/.cache/qwen3-speech/models/<org>/<model>``, overridable via
  ``cache_dir`` argument or ``QWEN3_CACHE_DIR`` env var
  (reference: HuggingFaceDownloader.swift:238-252).
"""

from __future__ import annotations

import os
import re
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

from .logging import download as log

DEFAULT_WEIGHT_PATTERNS = ("*.safetensors", "*.json", "*.txt", "*.model", "*.npy")

_RETRY_DELAYS = (0.0, 5.0, 15.0)


def sanitized_cache_key(model_id: str) -> str:
    """Sanitize a model id into a filesystem-safe relative path.

    Keeps the org/model hierarchy; strips anything that could escape the
    cache root (reference: HuggingFaceDownloader.sanitizedCacheKey)."""
    parts = []
    for part in model_id.split("/"):
        clean = re.sub(r"[^A-Za-z0-9._-]", "_", part)
        clean = clean.lstrip(".")  # no dotfiles / '..'
        if clean:
            parts.append(clean)
    if not parts:
        raise ValueError(f"unusable model id: {model_id!r}")
    return "/".join(parts[:2])


def validated_remote_file_name(name: str) -> str:
    """Reject remote file names that traverse outside the cache dir
    (reference: HuggingFaceDownloader.validatedRemoteFileName)."""
    if name.startswith("/") or name.startswith("\\"):
        raise ValueError(f"absolute remote path rejected: {name!r}")
    norm = os.path.normpath(name)
    if norm.startswith("..") or os.path.isabs(norm):
        raise ValueError(f"path traversal rejected: {name!r}")
    return norm


def get_cache_directory(model_id: str, cache_dir: Optional[str] = None) -> Path:
    if cache_dir is not None:
        root = Path(cache_dir)
    elif os.environ.get("QWEN3_CACHE_DIR"):
        root = Path(os.environ["QWEN3_CACHE_DIR"])
    else:
        root = Path.home() / ".cache" / "qwen3-speech" / "models"
    return root / sanitized_cache_key(model_id)


#: written after a snapshot_download finishes; its absence means a
#: download never completed (a partial fetch must not masquerade as a
#: cached model forever)
_COMPLETE_MARKER = ".snapshot_complete"


def _have_local_snapshot(target: Path, patterns: Sequence[str]) -> bool:
    if not target.is_dir():
        return False
    if (target / _COMPLETE_MARKER).exists():
        return True
    # Pre-staged caches (no marker): require an actual weight-bearing
    # file — metadata alone (a config.json left by an interrupted
    # download) is not a snapshot
    meta = {"*.json", "*.txt"}
    for pat in patterns:
        if pat in meta:
            continue
        if any(target.rglob(pat)):
            return True
    return False


def download_weights(
    model_id: str,
    cache_dir: Optional[str] = None,
    patterns: Sequence[str] = DEFAULT_WEIGHT_PATTERNS,
    additional_files: Sequence[str] = (),
    additional_patterns: Sequence[str] = (),
    offline_mode: bool = False,
    progress_handler: Optional[Callable[[float], None]] = None,
) -> Path:
    """Ensure a model snapshot is in the local cache; return its directory.

    Local directories pass through untouched (``model_id`` that exists on
    disk is used as-is), enabling fully offline operation with pre-staged
    weights. ``additional_patterns`` extend the default weight globs (e.g.
    ``*.pth``, ``voices/*`` for checkpoints that are not safetensors)."""
    if additional_patterns:
        patterns = list(patterns) + list(additional_patterns)
    as_path = Path(model_id)
    if as_path.is_dir():
        return as_path

    target = get_cache_directory(model_id, cache_dir)
    for name in additional_files:
        validated_remote_file_name(name)

    if offline_mode or os.environ.get("HF_HUB_OFFLINE") == "1":
        if _have_local_snapshot(target, patterns):
            log.info("offline: using cached snapshot at %s", target)
            return target
        raise FileNotFoundError(
            f"offline mode: no cached snapshot for {model_id} at {target}"
        )

    if _have_local_snapshot(target, patterns):
        log.info("using cached snapshot at %s", target)
        if progress_handler:
            progress_handler(1.0)
        return target

    last_err: Optional[Exception] = None
    for attempt, delay in enumerate(_RETRY_DELAYS):
        if delay:
            log.warning("retrying download of %s in %.0f s", model_id, delay)
            time.sleep(delay)
        try:
            from huggingface_hub import snapshot_download

            allow = list(patterns) + [validated_remote_file_name(f) for f in additional_files]
            target.mkdir(parents=True, exist_ok=True)
            snapshot_download(
                repo_id=model_id,
                local_dir=str(target),
                allow_patterns=allow,
            )
            (target / _COMPLETE_MARKER).touch()
            if progress_handler:
                progress_handler(1.0)
            return target
        except Exception as e:  # noqa: BLE001 — retry any transient failure
            last_err = e
            log.warning("download attempt %d failed: %s", attempt + 1, e)
    raise RuntimeError(f"failed to download {model_id} after {len(_RETRY_DELAYS)} attempts") from last_err
