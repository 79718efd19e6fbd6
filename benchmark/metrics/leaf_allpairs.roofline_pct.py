"""Share of its byte roofline the leaf all-pairs kernel reaches over the
builds of the traced window: the least time the builds' leaf init needs
(``work.leaf_allpairs_bytes`` from the cell's shapes and pinned
parameters, over the H100's 3.35 TB/s) over the summed device time of the
kernels whose name holds ``leaf_allpairs``. Bytes bound it: even if every
row met 63 others in fp32, the operations would take less time."""

from benchmark import work


def read(run):
    if not run.trace or not run.builds:
        return None
    measured = run.trace.device_s("leaf_allpairs")
    if measured <= 0:
        return None
    nbytes = run.builds * work.leaf_allpairs_bytes(
        run.config["rows"], run.config["dim"], run.index["n_neighbors"], run.index["n_trees"])
    return work.roofline_pct(work.least_seconds(nbytes=nbytes), measured)
