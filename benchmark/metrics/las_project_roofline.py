"""B11 on `.las` (`csrc/las_project.cu`, `pcr_las_project`): percent of its
memory roofline a frame.  Its least bytes a frame are the 12-byte (pid,
depth, index) entry it writes for each point of the projected batches and
the 4-byte word of each 10-10-10 plane the visible batches' levels read,
from the port's counters `las.batches` and `las.planes_needed`; a culled
batch's points write their entries too, so the count is what the kernel
must move at least."""

from benchmark import program
from benchmark.roofline import share

UNIT = "%"
LAYER = "kernels: .las projection"
MOVES = "points_per_s"
SYMBOL = "pcr_las_project"
POINTS_PER_BATCH = 65536


def read(rec):
    t = rec.get("trace")
    if not t or t["own_s"].get(SYMBOL, 0.0) <= 0:
        return None
    batches = program.per_frame(rec, "las.batches")
    planes = program.per_frame(rec, "las.planes_needed")
    if batches is None or planes is None:
        return None
    return share(POINTS_PER_BATCH * (12 * batches + 4 * planes), t["own_s"][SYMBOL] / t["frames"])
