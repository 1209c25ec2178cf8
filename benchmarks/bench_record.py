"""Recording-surface benchmark: the `demo --record` workflow's realtime
multiple.

Flies the single-vehicle orchard loop through OrchardBridge with a
bus-wide MessageRecorder attached (the rosbag_record_airsim.sh
workflow: full topic surface, image topics excluded) and measures the
synced `fly_frames_block` loop vs the pipelined
`fly_frames_pipelined` loop (device block k overlaps host publish of
block k-1 — the surface is host-publish bound, so the pipeline hides
the whole flight behind serialization work).

    python -m benchmarks.bench_record [--cpu] [--image WxH]
           [--candidates N] [--blocks 16,24,32] [--reps N]
"""

import sys
import tempfile
import time

import numpy as np


def main(argv):
    from benchmarks import _util

    argv = _util.setup(argv)
    img = argv[argv.index("--image") + 1] if "--image" in argv else "640x480"
    n_cand = int(argv[argv.index("--candidates") + 1]) \
        if "--candidates" in argv else 256
    blocks = [int(x) for x in (
        argv[argv.index("--blocks") + 1] if "--blocks" in argv
        else "16,32").split(",")]
    reps = int(argv[argv.index("--reps") + 1]) if "--reps" in argv else 18
    w, h = (int(x) for x in img.split("x"))

    from agrifly_tpu.io import bridge as bridge_mod
    from agrifly_tpu.sim import orchard_env

    params = orchard_env.make_params(width=w, height=h,
                                     n_candidates=n_cand)
    ob = bridge_mod.OrchardBridge(params, vehicle_id=1, seed=0,
                                  publish_images=False)
    with tempfile.NamedTemporaryFile(suffix=".bag") as f:
        rec = bridge_mod.MessageRecorder(ob.bus, f.name)
        frame_s = int(params.steps_per_frame) * int(params.base.dt_us) * 1e-6

        blk0 = blocks[0]
        ob.fly_frames_block(blk0)  # compile
        t0 = time.perf_counter()
        for _ in range(reps):
            ob.fly_frames_block(blk0)
        synced = (time.perf_counter() - t0) / reps
        _util.report(f"record_synced_blk{blk0}_x_realtime",
                     round(blk0 * frame_s / synced, 2), "x")

        for blk in blocks:
            ob.fly_frames_pipelined(blk, blk)  # compile
            t0 = time.perf_counter()
            ob.fly_frames_pipelined(reps * blk, blk)
            piped = (time.perf_counter() - t0) / reps
            _util.report(f"record_pipelined_blk{blk}_x_realtime",
                         round(blk * frame_s / piped, 2), "x")
        rec.close()
        print(f'{{"messages": {rec.count}}}')


if __name__ == "__main__":
    main(sys.argv[1:])
