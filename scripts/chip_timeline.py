#!/usr/bin/env python3
"""Seconds each phase of a ``chip_smoke.py`` run took, from its stamped log.

Stamp every line of a run (each line prefixed with the wall clock)::

    python3 -u chip_smoke.py | while IFS= read -r l; do
        printf "%s %s\\n" "$(date +%s.%N)" "$l"; done > run.log

then::

    python3 scripts/chip_timeline.py run.log [parent.log ...]

prints, for each log, the offset of every phase header from the log's first
line and the seconds to the next header, then a table of the segments
``PERF.md`` §5 keeps (header to header), one column per log, and the run's
own clock (its ``the whole run took`` line).  A phase header that appears
twice (the float32 repeat) is counted by occurrence."""

from __future__ import annotations

import re
import sys
from collections import defaultdict

HEADER = re.compile(r"(phases? \d+[^:]*):")
#: (segment, from header, to header); a header is (name, occurrence)
SEGMENTS = (
    ("phase 3", ("phase 3", 1), ("phase 4", 1)),
    ("phase 4", ("phase 4", 1), ("phase 5", 1)),
    ("phase 5", ("phase 5", 1), ("phase 6", 1)),
    ("phase 6", ("phase 6", 1), ("phase 7", 1)),
    ("phase 7", ("phase 7", 1), ("phase 8", 1)),
    ("phase 8", ("phase 8", 1), ("phase 10", 1)),
    ("phase 10", ("phase 10", 1), ("phase 13", 1)),
    ("phase 13", ("phase 13", 1), ("phase 3", 2)),
    ("the float32 repeat", ("phase 3", 2), ("phase 9", 1)),
    ("phase 9", ("phase 9", 1), ("phase 12", 1)),
    ("phase 12", ("phase 12", 1), ("phase 14", 1)),
    ("phase 14", ("phase 14", 1), ("phases 15-17", 1)),
    ("phases 15-17", ("phases 15-17", 1), ("phase 18", 1)),
    ("phase 18 (and 22)", ("phase 18", 1), ("phase 19", 1)),
    ("phase 19 (and 20-21)", ("phase 19", 1), ("end", 1)),
)


#: a header that names several phases (phase 18's process runs phase 22
#: too), by the one the segments start at
ALIASES = {"phases 18 and 22": "phase 18"}


def read(path: str) -> tuple[dict, list, float | None]:
    """(header -> offset, [(offset, line)] of headers, the run's clock)."""
    heads, listed, total = {}, [], None
    seen: dict = defaultdict(int)
    t0 = last = None
    with open(path, errors="replace") as f:
        for line in f:
            stamp, _, text = line.rstrip("\n").partition(" ")
            try:
                t = float(stamp)
            except ValueError:
                continue
            t0 = t if t0 is None else t0
            last = t - t0
            m = HEADER.match(text)
            if m and not text.startswith(" "):
                name = m.group(1).split(" (")[0] if m.group(1).startswith("phases") else (
                    " ".join(m.group(1).split()[:2]))
                name = ALIASES.get(name, name)
                seen[name] += 1
                heads[(name, seen[name])] = t - t0
                listed.append((t - t0, text[:100]))
            if "the whole run took" in text:
                total = float(text.split("took")[1].split()[0])
    heads[("end", 1)] = last
    return heads, listed, total


def main(paths: list[str]) -> int:
    runs = [read(p) for p in paths]
    for path, (_heads, listed, _total) in zip(paths, runs):
        print(path)
        for i, (t, text) in enumerate(listed):
            nxt = listed[i + 1][0] if i + 1 < len(listed) else t
            print(f"  {t:8.1f} +{nxt - t:7.1f}  {text}")
    print(f"{'segment':20s}" + "".join(f"{p[-24:]:>26s}" for p in paths))
    for name, a, b in SEGMENTS:
        cells = []
        for heads, _listed, _total in runs:
            cells.append(f"{heads[b] - heads[a]:26.1f}" if a in heads and b in heads
                         else f"{'-':>26s}")
        print(f"{name:20s}" + "".join(cells))
    print(f"{'the whole run':20s}" + "".join(
        f"{total:26.1f}" if total is not None else f"{'-':>26s}" for _h, _l, total in runs))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
