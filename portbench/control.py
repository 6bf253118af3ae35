"""The readings that a cell's correctness limits are set from: the
program's numbers on many seeds (the lower readings) and its control's on
a few (the upper readings), in one process.

    python3 portbench/control.py --workload CELL --seconds S \
        --seeds N,N,... --control-seeds N,N,...

The control is the one portbench/checks/<cell>.json names: "program",
the program built with the configuration's fields replaced by the
control's (a path of lower precision of its own), run as a benchmark run
is and checked against the cell's reference; or "reference", the plain
reference computed with `levels` in place of the configuration's integer
range (w4a4 for a w8a8 configuration), tracked from a fresh tracker over
as many chunks as a run checks, against the reference itself. Prints one
JSON line a seed and a last line with, per number, the largest program
reading and the smallest control reading.
"""
import argparse
import collections
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

Track = collections.namedtuple("Track", "track_id score bbox keypoints")


def reference_control(cell, seed: int, levels: int, device, root=ROOT):
    """The numbers of the reference at `levels` against the reference."""
    from portbench.harness import check as CK
    from portbench.reference.scene import render_clip
    from portbench.run import sequence_index
    cfg, tr = cell.config, cell.traffic
    clip = render_clip(tr["clip_frames"], tr["width"], tr["height"],
                       tr["persons"], seed, tuple(tr["scale_range"]),
                       tr["speed"])
    params = CK.M.read_checkpoint(os.path.join(root, cfg["checkpoint"]))
    chk = tr["check"]
    n = chk["start_chunks"] + chk["sampled_chunks"] + int(chk["last_chunk"])
    out = []
    for lv in (None, levels):
        convs = CK.reference_convs(cfg, params, seed, device, lv, root)
        dets = CK.reference_detections(cfg, convs, clip, device, root=root)
        frames, ends, state = [], [], None
        for c in range(n):
            f, trk = CK.reference_tracks(cfg, dets, sequence_index(tr, c),
                                         state, tr["width"], tr["height"])
            state = trk.s
            frames += f
            ends.append(CK.state_ids(state))
        out.append((frames, ends))
    (ref, ref_ends), (ctl, ctl_ends) = out
    ctl = [[Track(t, s, b, p) for t, s, p, b in fr] for fr in ctl]
    return CK.compare([(ctl, ref, list(zip(ctl_ends, ref_ends)))])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    import torch

    from portbench import run
    from portbench.harness import check as CK
    from portbench.harness import spec
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    control = cell.check["control"]
    readings = {"program": [], "control": []}
    for kind, seeds in (("program", args.seeds),
                        ("control", args.control_seeds)):
        for seed in [int(s) for s in seeds.split(",") if s]:
            base = ["--workload", args.workload, "--seed", str(seed),
                    "--seconds", str(args.seconds), "--trace", "0"]
            if kind == "program":
                nums = run.main(base)["numbers"]
            elif control["kind"] == "program":
                nums = run.main(base, program_config={
                    **cell.config, **control["config"]})["numbers"]
            else:
                nums = reference_control(cell, seed, control["levels"],
                                         torch.device("cuda"))
            readings[kind].append(nums)
            print(json.dumps({"reading": kind, "seed": seed, **nums}),
                  flush=True)
    summary = {}
    for n in CK.NAMES:
        lo = [r[n] for r in readings["program"]]
        hi = [r[n] for r in readings["control"]]
        summary[n] = {"lower": max(lo) if lo else None,
                      "upper": min(hi) if hi else None}
    print(json.dumps({"summary": summary}), flush=True)


if __name__ == "__main__":
    main()
