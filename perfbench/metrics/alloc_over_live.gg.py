"""Allocated element slots (``memory_elems()``) over the live elements
after the insert phase; §V bounds it by 2 + B0·blocks/n."""


def read(rec):
    return rec.alloc_over_live
