"""Multi-rendition ABR ladder (x265 analog: abrEncApp.{h,cpp} —
AbrEncoder + per-rendition PassEncoder/Reader/Scaler threads sharing a
picture ring; SURVEY.md §2.4 P6).

Batched design: renditions are independent encoder instances fed from
one shared source via the jitted downscaler. On a single host they run
round-robin (the reader/scaler threads collapse into this loop); across
hosts each rendition (or GOP segment) pins to a jax.distributed process —
`renditions_for_process` gives the static process->rendition shard so the
same script runs unchanged on 1..N hosts with DCN carrying only the
source frames.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from x265_tpu.api.encoder import Encoder
from x265_tpu.api.params import Param, RC_ABR, param_default_preset
from x265_tpu.io.scaler import scale_frame


@dataclass
class Rendition:
    width: int
    height: int
    bitrate_kbps: int
    preset: str = "medium"


def renditions_for_process(renditions: List[Rendition],
                           process_index: int = 0,
                           process_count: int = 1) -> List[int]:
    """Static rendition->host shard (round-robin, matches the NUMA-pool
    isolation of abrEncApp)."""
    return [i for i in range(len(renditions))
            if i % process_count == process_index]


class AbrLadder:
    """Encode one source into several renditions."""

    def __init__(self, src_width: int, src_height: int,
                 renditions: List[Rendition], fps=(25, 1),
                 process_index: int = 0, process_count: int = 1):
        self.renditions = renditions
        self.mine = renditions_for_process(renditions, process_index,
                                           process_count)
        self.encoders = {}
        for i in self.mine:
            r = renditions[i]
            p = param_default_preset(r.preset)
            p.width, p.height = r.width, r.height
            p.rc_mode = RC_ABR
            p.bitrate = r.bitrate_kbps
            p.fps_num, p.fps_den = fps
            self.encoders[i] = Encoder(p)
        self.streams = {i: [self.encoders[i].headers()] for i in self.mine}

    def push(self, frame) -> None:
        """Feed one source frame; scaled + encoded into every rendition
        owned by this process (Reader+Scaler thread analog)."""
        for i in self.mine:
            r = self.renditions[i]
            scaled = scale_frame(frame, r.height, r.width)
            self.streams[i].append(self.encoders[i].encode_frame(*scaled))

    def finish(self):
        """Flush all renditions; returns {rendition_index: annexb bytes}."""
        out = {}
        for i in self.mine:
            self.streams[i].append(self.encoders[i].flush())
            out[i] = b"".join(self.streams[i])
        return out

    def stats(self):
        return {i: self.encoders[i].get_stats() for i in self.mine}
