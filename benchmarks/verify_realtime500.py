"""Wall-clock 500 Hz wire-level simulator verification.

The reference's real-time simulator node promises 500 Hz wall-clock
pacing of the vehicle loop with the full topic surface (HardwareTimer +
ros::Rate(500), AIFS_ROS/hiperlab_rostools/src/Simulator/main.cpp:231,
310). The CPU CI validates the pacing logic at a reduced rate
(tests/test_realtime.py); this script holds the TRUE 500 Hz on the
device via SimBridge.run_realtime(device_blocks=True)
— one lax.scan jit call per quantum on the packed state carrier,
pipelined one quantum deep — and checks: achieved tick rate within the
mocap band's +-2.5%, <5% late quanta, and the wall-clock mocap/telemetry
topic rates inside the reference vehicle_monitor health bands
(unscaled: at 500 Hz sim time IS wall time). Prints one JSON line.

The quantum is 40 ticks (80 ms), an untuned default: each quantum pays
one device read (the pipelined read of the previous quantum's row
matrix), so the quantum must stay well above the device-read latency.

    python -m benchmarks.verify_realtime500 [--cpu] [--duration 10]
"""

import json
import sys

from benchmarks import _util


def main(argv):
    argv = _util.setup(argv)
    duration = (float(argv[argv.index("--duration") + 1])
                if "--duration" in argv else 10.0)

    from agrifly_tpu.io import bridge as bridge_mod
    from agrifly_tpu.sim import env as env_mod

    params = env_mod.make_params(noise_scale=1.0)
    br = bridge_mod.SimBridge(params, vehicle_id=1, seed=0)
    cmd = env_mod.hover_command()
    report = br.run_realtime(duration, cmd, rate_hz=500.0, block=40,
                             device_blocks=True)

    checks = {
        "achieved_tick_hz": report["achieved_tick_hz"],
        "rate_in_band": bool(
            abs(report["achieved_tick_hz"] - 500.0) / 500.0 < 0.025),
        "late_quanta": report["late_quanta"],
        "n_quanta": report["n_quanta"],
        "late_ok": bool(report["late_quanta"] < 0.05 * report["n_quanta"]),
        "max_late_ms": report["max_late_s"] * 1e3,
        "mocap_hz_wall": report["topic_hz"]["mocap"],
        "telemetry_hz_wall": report["topic_hz"]["telemetry"],
        "truth_hz_wall": report["topic_hz"]["truth"],
        "mocap_band_ok": report["bands_ok"].get("mocap", False),
        "telemetry_band_ok": report["bands_ok"].get("telemetry", False),
    }
    ok = (checks["rate_in_band"] and checks["late_ok"]
          and checks["mocap_band_ok"] and checks["telemetry_band_ok"])
    print(json.dumps({"metric": "realtime500_ok", "value": bool(ok),
                      "unit": "bool", **checks}))
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main(sys.argv[1:])
