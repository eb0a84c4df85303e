"""The hand-written kernels' least time over their device time: for
each kernel that ran and has a byte count, the bytes of its stage in
every traced query at the card's memory rate, summed, over the summed
device time of its symbols."""
from portbench import roofline

UNIT, LAYER, MOVES = "%", "kernels", "input_rows_per_s"


def read(r):
    least = spent = 0.0
    for name in r.rooflines:
        got = roofline.kernel_times(r, name)
        if got is not None:
            least += got[0]
            spent += got[1]
    return 100.0 * least / spent if spent > 0 else None
