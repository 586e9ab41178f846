"""Blocks, the unit the batch pipeline moves: the port's copy of the
pieces of ``ray_tpu/data/block.py`` (``:17-68``) that
:mod:`ray_tpu_torch.data.llm` uses.

A block is either a list of rows (``simple``) or a dict of equal-length
numpy columns (``tabular``), laid out as the reference lays them out, so
the same blocks feed both packages.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Union

import numpy as np

Row = Dict[str, Any]
Block = Union[List[Any], Dict[str, np.ndarray]]


def is_tabular(block: Block) -> bool:
    return isinstance(block, dict)


def block_len(block: Block) -> int:
    if is_tabular(block):
        if not block:
            return 0
        return len(next(iter(block.values())))
    return len(block)


def iter_rows(block: Block) -> Iterator[Any]:
    if is_tabular(block):
        keys = list(block.keys())
        for i in range(block_len(block)):
            yield {k: block[k][i] for k in keys}
    else:
        yield from block


def rows_to_block(rows: List[Any]) -> Block:
    """Build a tabular block when rows are uniform dicts, else simple."""
    if rows and all(isinstance(r, dict) for r in rows):
        keys = list(rows[0].keys())
        if all(list(r.keys()) == keys for r in rows):
            try:
                return {k: np.asarray([r[k] for r in rows]) for k in keys}
            except Exception:
                pass
    return list(rows)
