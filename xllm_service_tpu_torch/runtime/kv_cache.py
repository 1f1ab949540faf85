"""Host-side page allocator of the paged KV pool.

A copy of the JAX package's ``PageAllocator``: page ids are handed out
from ``[1, num_pages)``, and page 0 is the NULL page that every writer
drops and that no sequence owns. The prefix cache, the host spill tier
and the KV block codec of the JAX package are not part of this package
yet.
"""

from __future__ import annotations

from typing import List, Optional, Sequence


class PageAllocator:
    """Free-list page allocator over ids [1, num_pages)."""

    def __init__(self, num_pages: int) -> None:
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is NULL)")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))

    @property
    def num_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: Sequence[int]) -> None:
        for p in pages:
            if not 0 < p < self.num_pages:
                raise ValueError(f"bad page id {p}")
            self._free.append(p)
