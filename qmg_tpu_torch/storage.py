"""A check-out / check-in pool of zeroed fields (port of
qmg_tpu/storage.py, the reference's ArrayStorageMG).

PyTorch's caching allocator owns the buffers, so the pool hands out fresh
zeroed tensors; what it keeps is the reference's discipline: handles are
counted, a handle from elsewhere or checked in twice is refused, and
``consolidate`` drops unused slots.
"""

from __future__ import annotations

from typing import List

import torch


class ArrayStorageMG:
    def __init__(self, shape, count: int = 6, dtype=torch.complex128,
                 device="cuda"):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.device = device
        self._free: List[int] = list(range(count))
        self._all = set(self._free)
        self._next_id = count

    def check_out(self):
        """(handle, zeroed tensor); the pool grows when none is free."""
        if self._free:
            h = self._free.pop()
        else:
            h = self._next_id
            self._next_id += 1
            self._all.add(h)
        return h, torch.zeros(self.shape, dtype=self.dtype,
                              device=self.device)

    def check_in(self, handle: int):
        if handle not in self._all:
            raise ValueError("check_in of a vector not from this pool")
        if handle in self._free:
            raise ValueError("double check_in")
        self._free.append(handle)

    def get_number_allocated(self) -> int:
        return len(self._all)

    def get_number_checked(self) -> int:
        return len(self._all) - len(self._free)

    def consolidate(self, min_keep: int = 0):
        """Drop free slots down to max(min_keep, checked out). As in
        qmg_tpu, the number dropped is counted from the next handle, not
        from the slots held, so a later call can go below the floor
        (ROADMAP F8)."""
        keep = max(min_keep, self.get_number_checked())
        drop = min(len(self._free), self._next_id - keep)
        for _ in range(drop):
            self._all.discard(self._free.pop())
