"""One module a hand-written kernel of the port whose stage a cell
runs (``rooflines/<kernel>.py``, the name ``ops/kernels.KERNELS`` gives
it): ``stage_bytes(stats)``, the bytes the kernel's stage must move in
one query, counted from the cell's shapes and the reference's counts
(each input byte read once, each output byte written once), or None
where the query has no such stage. The count is of the stage's work,
not of the kernel's code, so it stays the same whatever implements the
stage. The kernel's device symbols are in ``kernels.json``; a kernel
that list lacks gives its own as ``SYMBOLS`` here."""
