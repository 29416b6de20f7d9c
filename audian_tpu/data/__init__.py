"""Host-side data layer: audio I/O, out-of-core loading, and the public
``Data`` API over the device trace graph."""

from . import wavio
from .wavio import (
    load_audio,
    write_audio,
    metadata,
    markers,
    get_datetime,
    update_starttime,
    bext_history_str,
    add_history,
    unwrap,
)
from .loader import AudioLoader
from .data import Data, Trace, RawTrace, default_traces

__all__ = [
    "wavio",
    "load_audio",
    "write_audio",
    "metadata",
    "markers",
    "get_datetime",
    "update_starttime",
    "bext_history_str",
    "add_history",
    "unwrap",
    "AudioLoader",
    "Data",
    "Trace",
    "RawTrace",
    "default_traces",
]
