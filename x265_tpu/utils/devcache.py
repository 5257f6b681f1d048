"""Small keyed cache for host->device uploads.

Reference planes are reused across many frames (DPB anchors serve ~4-8
encodes each) but the per-frame pipeline used to re-upload them on every
dispatch — ~4-8 MB x several uploads per frame.
Entries are keyed by (tag, id(src), ...) and pin the source array so a
recycled id cannot alias a dead array.
"""
from __future__ import annotations

from collections import OrderedDict

_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
_MAX = 48


def get_or(key: tuple, src, build):
    """Return the cached device value for (key, src), building once."""
    ent = _cache.get(key)
    if ent is not None and ent[0] is src:
        _cache.move_to_end(key)
        return ent[1]
    val = build()
    _cache[key] = (src, val)
    while len(_cache) > _MAX:
        _cache.popitem(last=False)
    return val


def src_plane(arr, bd: int):
    """Cached device upload of a source plane on the thin wire dtype
    (uint8 for 8-bit, int16 for 10/12-bit). Source planes are consumed
    by several dispatches per frame (residual pre, SAO stats, RD);
    caching by identity uploads each plane once per frame."""
    import numpy as np
    import jax.numpy as jnp

    wire = np.uint8 if bd == 8 else np.int16

    def build(a=arr):
        return jnp.asarray(np.asarray(a, wire))

    return get_or(("src", id(arr), bd), arr, build)


def clear() -> None:
    _cache.clear()
