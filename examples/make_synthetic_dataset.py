"""Build a multi-log, full-size synthetic AV2-layout dataset.

Produces train/ and val/ splits of scripted scenes whose vehicle tracks
cover every intention class the heuristic labeler can assign (reference
heuristic_labeling.py:10-124): keep-lane movers, parked cars, decelerating
(stopping) cars, left/right turners, and lane changers — then runs the
intent-label precompute over both splits so the result is directly
trainable with ``intentbev-train`` at full flagship geometry.

Used for the training-quality evidence run (docs/TRAINING.md): no real
Argoverse 2 data exists in this environment, so metric parity can only be
evidenced as a learning TREND (mAP/F1 rising over steps) on this dataset.

Usage:
    python examples/make_synthetic_dataset.py --out /data/synth \
        --train_logs 6 --val_logs 2 --frames 40 --points 30000
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from intentbev.data.synthetic import (  # noqa: E402
    curved_arc_point,
    curved_multi_lane_map_data,
    inject_label_noise,
    multi_lane_map_data,
    write_synthetic_log,
)
from intentbev.precompute_labels import run as precompute_run  # noqa: E402


def stopper_track(
    rng: np.random.Generator,
    stop_x: float,
    y: float,
    direction: float,
    num_frames: int,
    start_dist: float,
) -> np.ndarray:
    """World-frame [num_frames, 3] track for a 3-phase stop at ``stop_x``:
    approach at cruise speed, brisk brake to a creep, creep to the line,
    halt. The phase design targets the heuristic's bands (3 s future
    window, avg-speed thresholds 0.5 / 1.0 m/s): a uniform-decel stop
    spends as many rows in the [0.5, 1.0) m/s dead zone (labeled OTHER)
    as in the STOPPING band, and the two look visually identical — the
    creep phase instead crosses the dead zone in <1 s at cruise speed and
    stretches the STOPPING band to ~2-3 s of track (docs/TRAINING.md).
    ``direction`` +1 drives +x (yaw 0), -1 drives -x (yaw pi);
    ``start_dist`` is the initial distance to the stop line."""
    dt = 0.1
    cruise = float(rng.uniform(1.8, 2.6))
    creep = float(rng.uniform(0.30, 0.45))
    creep_dist = float(rng.uniform(1.0, 1.3))
    brake = 2.0  # m/s^2, cruise -> creep
    brake_dist = (cruise * cruise - creep * creep) / (2.0 * brake)
    yaw = 0.0 if direction > 0 else float(np.pi)
    out = np.empty((num_frames, 3))
    r = float(start_dist)  # distance still to go
    for i in range(num_frames):
        out[i] = (stop_x - direction * r, y, yaw)
        if r <= 0.02:
            v = 0.0
        elif r <= creep_dist:
            v = creep
        elif r <= creep_dist + brake_dist:
            v = min(cruise, float(np.sqrt(creep * creep + 2.0 * brake * (r - creep_dist))))
        else:
            v = cruise
        r = max(0.0, r - v * dt)
    return out


def scripted_vehicles(
    rng: np.random.Generator, crosswalk_x: float, num_frames: int = 60
) -> list[dict]:
    """A scene mix covering the intent taxonomy with SEPARABLE cues for
    every class (ego moves +x at 5 m/s; BEV covers x in [-20, 60],
    y in [-72, 72] ego-relative; map = ``multi_lane_map_data``: 4 lanes
    with centers y in {+-1.75, +-5.25}, fills covering |y| <= 7).

    Class-cue design (what the MODEL can see in the 10-sweep BEV + map):
    - KEEP_LANE: fast in-lane movers, long motion smear across sweeps.
    - PARKED (off-lane): |y| in [8.8, 10.5] — outside every lane fill in
      the map stream — zero motion smear. Plus one stopped-in-lane car
      (the heuristic labels any fully-stopped car PARKED, reference
      heuristic_labeling.py:54-55), so PARKED must be learned from the
      zero-motion cue, with the map cue as support.
    - STOPPING: gentle decelerations (a = v0^2/2d chosen to stop 1.5-3 m
      short of the crosswalk) — the labeler's STOPPING band (future
      displacement in [0.5, 1.5] m at future avg speed < 0.5 m/s,
      heuristic thresholds) then covers ~1 s of track instead of the
      ~0.4 s a hard 2-5 m/s^2 stop gives; the visible cues are a short
      motion smear + proximity to the crosswalk channel.
    - TURN / LANE_CHANGE: yaw-rate-integrated curved tracks (>20 deg and
      5-20 deg heading change over the 3 s horizon respectively).
    - OTHER: two scripted signatures for the heuristic's escape branch —
      diagonal drifters (heading fixed, lateral velocity: future leaves
      the lane polygons at dh ~ 0) and off-road movers (driving in the
      off-lane parked band). Before these, OTHER was only the track-end
      rows (< 5 future annotation steps) — pure label noise with no
      coherent signature, which capped its F1 at ~0.08 (docs/TRAINING.md).
    """
    vehicles: list[dict] = []

    def center_y(side: str = "any") -> float:
        if side == "fwd":
            choices = [1.75, 5.25]
        elif side == "onc":
            choices = [-1.75, -5.25]
        else:
            choices = [1.75, 5.25, -1.75, -5.25]
        return float(rng.choice(choices)) + float(rng.normal(0, 0.15))

    # 4 forward keep-lane movers
    for _ in range(4):
        vehicles.append({
            "start": (float(rng.uniform(5.0, 50.0)), center_y("fwd")),
            "velocity": (float(rng.uniform(3.0, 8.0)), 0.0), "yaw": 0.0,
        })
    # 2 oncoming keep-lane movers (heading -x in the y<0 lanes)
    for _ in range(2):
        v = float(rng.uniform(3.0, 8.0))
        vehicles.append({
            "start": (float(rng.uniform(35.0, 55.0)), center_y("onc")),
            "velocity": (-v, 0.0), "yaw": float(np.pi),
        })
    # 2 parked off-lane (curbside rows, outside the lane fills)
    for _ in range(2):
        side = float(rng.choice([-1.0, 1.0]))
        vehicles.append({
            "start": (float(rng.uniform(5.0, 45.0)),
                      side * float(rng.uniform(8.8, 10.5))),
            "velocity": (0.0, 0.0),
            "yaw": 0.0 if side > 0 else float(np.pi),
        })
    # 1 stopped-in-lane (zero motion, in-lane -> also PARKED per heuristic)
    vehicles.append({
        "start": (float(rng.uniform(10.0, 45.0)), center_y()),
        "velocity": (0.0, 0.0), "yaw": 0.0,
    })
    # 6 stopping: 3-phase stops (see ``stopper_track``) queued short of
    # the crosswalk. Start distances are STAGGERED so the labeler's
    # STOPPING band is populated somewhere in the scene at every frame
    # of the log, not just in one early burst.
    for i in range(6):
        # distinct queue slot per stopper (~6 m pitch) so same-lane cars
        # halt like a queue at a light, never overlapping GT boxes
        gap = 1.5 + 6.0 * (i // 2) + float(rng.uniform(0.0, 1.5))
        start_dist = 1.5 + 3.2 * i / 2 + float(rng.uniform(0.0, 1.8))
        if i % 3 != 2:  # forward lanes, approaching from -x
            vehicles.append({"track": stopper_track(
                rng, crosswalk_x - gap, center_y("fwd"), +1.0,
                num_frames, start_dist)})
        else:      # oncoming lane, approaching from +x
            vehicles.append({"track": stopper_track(
                rng, crosswalk_x + 2.5 + gap, center_y("onc"), -1.0,
                num_frames, start_dist)})
    # 2 turners (>20 deg heading change within the 3 s horizon)
    for sign in (1.0, -1.0):
        vehicles.append({
            "start": (float(rng.uniform(10.0, 45.0)), center_y("fwd")),
            "velocity": (float(rng.uniform(3.0, 6.0)), 0.0), "yaw": 0.0,
            "yaw_rate": sign * float(rng.uniform(0.25, 0.45)),
        })
    # 4 lane changers (5-20 deg drift over the horizon). Three cue
    # decisions target the classes' F1 plateau at ~0.35 (docs/TRAINING.md
    # — LEFT/RIGHT_CHANGE were the weakest non-OTHER classes):
    # (a) yaw_rate 0.075-0.11 rad/s -> dh over the 3 s horizon is
    #     12.9-18.9 deg: max margin from BOTH label boundaries (5 deg
    #     KEEP_LANE, 20 deg TURN) and ~2.5x the old band's lower edge, so
    #     the visible curvature separates further from keep-laners;
    # (b) speeds 5-9 m/s: a faster car sweeps a longer 10-sweep motion
    #     smear, making the same curvature visibly larger (lateral offset
    #     grows ~ v*w*t^2/2);
    # (c) a random maneuver PHASE (initial heading 0-8 deg into the
    #     drift, with the matching lateral offset off the lane center):
    #     mid-maneuver cars straddle the dashed boundary — the map-
    #     relative cue a real lane change shows — instead of every
    #     example starting dead-center. dh is phase-invariant (constant
    #     yaw rate), so labels stay LANE_CHANGE throughout.
    for i in range(4):
        sign = 1.0 if i % 2 == 0 else -1.0
        phase = float(rng.uniform(0.0, 0.14))  # rad, 0-8 deg
        vehicles.append({
            "start": (float(rng.uniform(5.0, 45.0)),
                      center_y("fwd") + sign * phase * 12.0),
            "velocity": (float(rng.uniform(5.0, 9.0)), 0.0),
            "yaw": sign * phase,
            "yaw_rate": sign * float(rng.uniform(0.075, 0.11)),
        })
    # 1 diagonal drifter: heading fixed but velocity has a lateral
    # component (crab-walk). dh stays ~0 so the labeler reaches the
    # lane-containment check, and the future escapes the current-lane(+
    # successor) polygons -> OTHER (reference heuristic_labeling.py:112-117).
    # Visual signature: motion smear diagonal to the box heading.
    vehicles.append({
        "start": (float(rng.uniform(5.0, 40.0)), center_y("fwd")),
        "velocity": (float(rng.uniform(3.0, 6.0)),
                     float(rng.choice([-1.0, 1.0]))
                     * float(rng.uniform(1.2, 1.8))),
        "yaw": 0.0,
    })
    # 1 off-road mover: driving along x where only parked cars sit
    # (|y| in [8.8, 10.5], outside every lane fill). A lane is still
    # within the 5 m map-search radius but never contains it -> OTHER.
    # Visual signature: motion smear in the off-lane band of the map.
    side = float(rng.choice([-1.0, 1.0]))
    vehicles.append({
        "start": (float(rng.uniform(5.0, 40.0)),
                  side * float(rng.uniform(8.8, 10.5))),
        "velocity": ((1.0 if side > 0 else -1.0)
                     * float(rng.uniform(2.5, 5.0)), 0.0),
        "yaw": 0.0 if side > 0 else float(np.pi),
    })
    return vehicles


def curved_scripted_vehicles(
    rng: np.random.Generator, radius: float, sign: float,
    num_frames: int = 60,
) -> list[dict]:
    """Scene mix on the curved 4-lane corridor
    (``curved_multi_lane_map_data``). Every vehicle is expressed through
    the integrator API: start/yaw from ``curved_arc_point`` and
    yaw_rate = v/(R-d) (the EXACT lane circle — same center, same radius
    — so a 'keep-laner' follows its lane indefinitely), plus the class's
    extra rate on top. The kinematic label bands (3 s horizon dh
    thresholds 5/20 deg) constrain the speed/rate envelopes:

    - KEEP_LANE: v <= 6.5, R >= 250 -> dh = 3v/R <= 4.5 deg < 5 ✓; but
      visually every keep-laner now CURVES, so curvature alone no longer
      separates them from lane-changers — the map's lane geometry does.
    - LANE_CHANGE: extra rate 0.06-0.085 at v in [3.5, 6]: total dh in
      [8.2, 18.7] deg for both drift directions — inside (5, 20) ✓.
    - TURN: extra 0.25-0.45 dominates the lane term -> > 20 deg ✓.
    - STOPPING: integrator decel to rest (no crosswalk on curved logs;
      the band is kinematic).
    - PARKED: off-lane band d = +-[8.8, 10.5] (outside every lane fill).
    - OTHER: off-road mover driving the off-lane band along the arc.
    """
    vehicles: list[dict] = []

    def arc_vehicle(t0, d, speed, extra_rate=0.0, oncoming=False,
                    accel=0.0):
        x, y, yaw = curved_arc_point(radius, t0, d, sign)
        r = radius - d
        if oncoming:
            yaw += float(np.pi)
            rate = -sign * speed / r + extra_rate
        else:
            rate = sign * speed / r + extra_rate
        return {
            "start": (x, y), "yaw": yaw,
            "velocity": (speed * float(np.cos(yaw)),
                         speed * float(np.sin(yaw))),
            "yaw_rate": rate, "accel": accel,
        }

    def lane_d(side: str) -> float:
        if side == "fwd":
            choices = [1.75, 5.25]
        else:
            choices = [-1.75, -5.25]
        return sign * (float(rng.choice(choices)) + float(rng.normal(0, 0.15)))

    # 5 forward + 2 oncoming keep-laners (dense -> occlusion chains)
    for _ in range(5):
        vehicles.append(arc_vehicle(
            float(rng.uniform(5.0, 50.0)), lane_d("fwd"),
            float(rng.uniform(3.0, 6.5))))
    for _ in range(2):
        vehicles.append(arc_vehicle(
            float(rng.uniform(35.0, 55.0)), lane_d("onc"),
            float(rng.uniform(3.0, 6.5)), oncoming=True))
    # 3 parked off-lane + 1 stopped-in-lane
    for _ in range(3):
        d = float(rng.choice([-1.0, 1.0])) * float(rng.uniform(8.8, 10.5))
        x, y, yaw = curved_arc_point(radius, float(rng.uniform(5.0, 45.0)),
                                     d, sign)
        vehicles.append({"start": (x, y), "yaw": yaw,
                         "velocity": (0.0, 0.0)})
    x, y, yaw = curved_arc_point(radius, float(rng.uniform(10.0, 45.0)),
                                 lane_d("fwd"), sign)
    vehicles.append({"start": (x, y), "yaw": yaw, "velocity": (0.0, 0.0)})
    # 3 stoppers: decelerate to rest mid-corridor
    for _ in range(3):
        v0 = float(rng.uniform(1.8, 2.6))
        vehicles.append(arc_vehicle(
            float(rng.uniform(8.0, 40.0)), lane_d("fwd"), v0,
            accel=-float(rng.uniform(0.55, 0.85))))
    # 2 turners
    for turn_sign in (1.0, -1.0):
        vehicles.append(arc_vehicle(
            float(rng.uniform(10.0, 45.0)), lane_d("fwd"),
            float(rng.uniform(3.0, 6.0)),
            extra_rate=turn_sign * float(rng.uniform(0.25, 0.45))))
    # 4 lane changers (see envelope in the docstring)
    for i in range(4):
        drift = (1.0 if i % 2 == 0 else -1.0) * float(rng.uniform(0.06, 0.085))
        vehicles.append(arc_vehicle(
            float(rng.uniform(5.0, 45.0)), lane_d("fwd"),
            float(rng.uniform(3.5, 6.0)), extra_rate=drift))
    # 1 off-road mover (OTHER): drives the off-lane band along the arc
    d = float(rng.choice([-1.0, 1.0])) * float(rng.uniform(8.8, 10.5))
    vehicles.append(arc_vehicle(
        float(rng.uniform(5.0, 40.0)), d, float(rng.uniform(2.5, 5.0))))
    return vehicles


def ego_profile(rng: np.random.Generator, mode: str, num_frames: int,
                ego_speed: float = 5.0) -> np.ndarray:
    """Per-frame ego x positions. ``stopped``: red light — ego stationary at
    x=0 the whole log, so ego frame == world frame and the heuristic's
    ego-relative labels (see data.synthetic.write_synthetic_log) equal the
    scripted absolute behaviors. ``cruise``: constant-velocity ego — labels
    pick up the reference's ego-relative semantics (a same-speed car labels
    PARKED, a truly parked car labels as moving), which is EXACTLY the
    noise real AV2 labels carry; kept as a minority so training still sees
    it and multi-sweep ego-compensation stays exercised."""
    if mode == "stopped":
        return np.zeros(num_frames)
    return np.arange(num_frames) * 0.1 * ego_speed


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--train_logs", type=int, default=10)
    p.add_argument("--val_logs", type=int, default=3)
    p.add_argument("--frames", type=int, default=50)
    p.add_argument("--points", type=int, default=30000,
                   help="LiDAR points per sweep (real AV2 is ~100k)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--hard", action="store_true",
                   help="hard ViT-vs-CNN benchmark preset: "
                        "ray-shadow occlusion (annotations "
                        "persist for shadowed cars), unannotated off-lane "
                        "clutter, HALF the logs on curved corridors "
                        "(keep-laners curve too — map context required), "
                        "and train-split label noise")
    p.add_argument("--occlusion", type=float, default=None,
                   help="shadowed-point drop probability "
                        "(default 0.9 with --hard, 0 otherwise)")
    p.add_argument("--clutter", type=int, default=None,
                   help="clutter objects per log "
                        "(default 14 with --hard, 0 otherwise)")
    p.add_argument("--label_noise", type=float, default=None,
                   help="train-split intent label flip rate "
                        "(default 0.15 with --hard, 0 otherwise)")
    args = p.parse_args(argv)

    occl = args.occlusion if args.occlusion is not None else (
        0.9 if args.hard else 0.0)
    clut = args.clutter if args.clutter is not None else (
        14 if args.hard else 0)
    noise = args.label_noise if args.label_noise is not None else (
        0.15 if args.hard else 0.0)

    root = Path(args.out)
    t0 = time.time()
    for split, count in (("train", args.train_logs), ("val", args.val_logs)):
        split_dir = root / split
        split_dir.mkdir(parents=True, exist_ok=True)
        for i in range(count):
            seed = args.seed * 1000 + (0 if split == "train" else 500) + i
            rng = np.random.default_rng(seed)
            # hard preset: every other log is a curved corridor (radius
            # 250-400 m, alternating bend direction; stationary ego —
            # the pose writer scripts ego motion along +x only, which is
            # wrong on an arc)
            curved = args.hard and i % 2 == 1
            if curved:
                radius = float(rng.uniform(250.0, 400.0))
                csign = 1.0 if (i // 2) % 2 == 0 else -1.0
                vehicles = curved_scripted_vehicles(
                    rng, radius, csign, args.frames)
                map_data = curved_multi_lane_map_data(radius, csign)
                ego_xs = np.zeros(args.frames)
                mode = f"curved R={radius:.0f} sign={csign:+.0f}"
                clutter_arc = (radius, csign)
            else:
                # ~2/3 stopped, ~1/3 cruise ego (see ego_profile
                # docstring); the pattern puts both modes in every split
                mode = "stopped" if i % 3 < 2 else "cruise"
                if mode == "stopped":
                    crosswalk_x = float(rng.uniform(10.0, 20.0))
                else:
                    crosswalk_x = float(rng.uniform(25.0, 45.0))
                vehicles = scripted_vehicles(rng, crosswalk_x, args.frames)
                if mode == "cruise":
                    # one co-mover at ego speed: zero relative motion, the
                    # ego-relative heuristic labels it PARKED — a visually
                    # consistent example of the reference's label semantics
                    vehicles.append({
                        "start": (float(rng.uniform(8.0, 25.0)), 1.75),
                        "velocity": (5.0, 0.0), "yaw": 0.0,
                    })
                map_data = multi_lane_map_data(crosswalk_x=crosswalk_x)
                ego_xs = ego_profile(rng, mode, args.frames)
                clutter_arc = None
            log_dir = write_synthetic_log(
                split_dir,
                log_id=f"{split}log{i:04d}aaaaaaaa",
                num_frames=args.frames,
                points_per_sweep=args.points,
                seed=seed,
                vehicles=vehicles,
                map_data=map_data,
                ego_xs=ego_xs,
                occlusion_drop=occl,
                num_clutter=clut,
                clutter_arc=clutter_arc,
            )
            print(f"wrote {log_dir} ({mode})", flush=True)
    print(f"logs written in {time.time()-t0:.1f}s; precomputing intent labels...",
          flush=True)
    precompute_run(str(root), ["train", "val"], force=True)
    if noise > 0.0:
        flips = inject_label_noise(root / "train", noise, seed=args.seed)
        print(f"label noise {noise:.0%} on train: "
              f"{sum(flips.values())} labels flipped across {len(flips)} logs")
    print(f"done in {time.time()-t0:.1f}s total")


if __name__ == "__main__":
    main()
