"""App-facing state containers (the reference's SpeechUI layer)."""

from .store import TranscriptSegment, TranscriptionStore  # noqa: F401
