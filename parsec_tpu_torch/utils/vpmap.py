"""Virtual-process map (reference parsec/vpmap.c, 663 LoC).

A vpmap partitions a context's execution streams into *virtual
processes*; work stealing never crosses a VP boundary (parsec.c:336-382).
The reference initializes the map from one of: flat (all streams in one
VP), fixed-size groups, a description file, or hwloc topology
(vpmap_init_from_{flat,parameters,file,hardware_affinity}).

Spec grammar for the ``vpmap`` MCA param:

- ``flat``              — one VP spanning every stream (default)
- ``nb:SIZE``           — VPs of SIZE consecutive streams
- ``list:0,0,1,1,...``  — explicit per-stream VP ids
- ``file:PATH``         — one line per VP: the number of streams in it
"""

from __future__ import annotations

from typing import List


def parse(spec: str, nb_cores: int) -> List[int]:
    """Return the vp id of each of ``nb_cores`` streams."""
    spec = (spec or "flat").strip()
    if spec == "flat":
        return [0] * nb_cores
    if spec.startswith("nb:"):
        size = max(1, int(spec[3:]))
        return [i // size for i in range(nb_cores)]
    if spec.startswith("list:"):
        ids = [int(x) for x in spec[5:].split(",") if x.strip() != ""]
        if len(ids) != nb_cores:
            # truncating a longer map could silently drop whole VPs (or
            # leave non-dense ids) — require an exact match
            raise ValueError(
                f"vpmap list names {len(ids)} streams, context has "
                f"{nb_cores}")
        _check_dense(ids)
        return ids
    if spec.startswith("file:"):
        sizes: List[int] = []
        with open(spec[5:]) as fh:
            for line in fh:
                line = line.split("#", 1)[0].strip()
                if line:
                    size = int(line)
                    if size <= 0:
                        raise ValueError(
                            f"vpmap file: VP size must be positive, "
                            f"got {size}")
                    sizes.append(size)
        ids = [vp for vp, size in enumerate(sizes) for _ in range(size)]
        if len(ids) > nb_cores:
            # truncation would silently drop whole VPs (same rule as
            # list: specs)
            raise ValueError(
                f"vpmap file names {len(ids)} streams, context has "
                f"{nb_cores}")
        if len(ids) < nb_cores:
            # remaining streams join a final VP (reference pads likewise)
            ids.extend([len(sizes)] * (nb_cores - len(ids)))
        _check_dense(ids)
        return ids
    raise ValueError(f"unknown vpmap spec {spec!r} "
                     "(flat | nb:SIZE | list:... | file:PATH)")


def _check_dense(ids: List[int]) -> None:
    """VP ids must be 0..max contiguous (the reference indexes
    context->virtual_processes by vp id)."""
    seen = sorted(set(ids))
    if seen != list(range(len(seen))):
        raise ValueError(f"vpmap ids must be dense 0..N-1, got {seen}")


def nb_vps(ids: List[int]) -> int:
    return max(ids) + 1 if ids else 0
