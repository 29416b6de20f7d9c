"""Version and the user cache directory for audian-tpu.

Counterpart of the reference's `src/audian/version.py:1-14` (version
string + user cache path); the cache path follows the XDG base
directory rule.
"""

import os
from pathlib import Path

__version__ = "0.5.0"
__year__ = "2026"


class _Dirs:
    """User directories (the user cache holds the fulltrace pyramid
    cache, see audian_tpu.cache.fulltrace)."""

    @property
    def user_cache_path(self):
        base = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
        return Path(base) / "audian-tpu"


audian_dirs = _Dirs()
