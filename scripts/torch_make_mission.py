"""Generate a mission command schedule from waypoints: the counterpart of
tools/make_mission.py, with the same arguments, printed line and file.

Given a polyline of waypoints and a speed, `build_mission` emits the
schedule the envs consume (per 30 Hz control step: the commanded position
as a displacement from the first waypoint, the speed and the heading of
the segment), constant-speed along each segment; the file is
mission_<name>.npz (compos, speed, orient) in `apex_tpu_torch/data/`,
where the port's mission loader (`envs/trajectory.CommandTrajectory`)
reads it, or in --out. A numpy job on the host: it uses no card.

Usage: python scripts/torch_make_mission.py --name zigzag --speed 1.4 \\
           --waypoints "0,0 5,0 5,5 10,5" [--hz 30] [--out DIR]
"""
import argparse
import os

import numpy as np

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "apex_tpu_torch", "data")


def build_mission(waypoints: np.ndarray, speed: float, hz: float = 30.0):
    """Constant-speed traversal of the polyline; yaw follows the segment
    headings (the reference's mission format: compos cumulative
    displacement, speed_cmd, orient)."""
    pts = np.asarray(waypoints, dtype=np.float64)
    compos, speeds, orients = [], [], []
    for a, b in zip(pts[:-1], pts[1:]):
        seg = b - a
        dist = np.linalg.norm(seg)
        if dist < 1e-9:
            continue
        heading = np.arctan2(seg[1], seg[0])
        n_steps = max(1, int(round(dist / speed * hz)))
        for i in range(n_steps):
            p = a + seg * (i + 1) / n_steps
            compos.append([p[0] - pts[0][0], p[1] - pts[0][1], 1.0])
            speeds.append(speed)
            orients.append(heading)
    return (np.asarray(compos, np.float32), np.asarray(speeds, np.float32),
            np.asarray(orients, np.float32))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--name", required=True)
    ap.add_argument("--speed", type=float, default=1.0)
    ap.add_argument("--hz", type=float, default=30.0)
    ap.add_argument("--waypoints", required=True,
                    help='space-separated "x,y" pairs')
    ap.add_argument("--out", default=OUT_DIR,
                    help="directory of the file (default: the port's data "
                    "directory, where its mission loader reads)")
    args = ap.parse_args(argv)

    pts = np.array([[float(v) for v in w.split(",")]
                    for w in args.waypoints.split()])
    compos, speeds, orients = build_mission(pts, args.speed, args.hz)
    out = os.path.join(args.out, f"mission_{args.name}.npz")
    np.savez_compressed(out, compos=compos, speed=speeds, orient=orients)
    print(f"wrote {out}: {len(speeds)} steps, "
          f"{len(pts)} waypoints at {args.speed} m/s")
    return out


if __name__ == "__main__":
    main()
