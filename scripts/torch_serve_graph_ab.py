"""What the fused forms' CUDA graphs cost or save a serving host, against a
second checkout (the parent commit), in interleaved arms on one card.

* **serve**: the serve_row ladder (``chip_smoke.py`` phase 5e (a), the
  reference bench's ``serve_sustained`` row) in three arms, ``parent``
  (the second checkout's package), ``graphs`` (this checkout) and
  ``eager`` (this checkout with every form's body run eagerly), each
  round of arms in a rotated order; per arm its docs/s at the SLO, its
  rungs' p99 apply latency, its graph captures and its traced session's
  graph counts;
* **wide**: phase 5e (b)'s serve_2048 ladder and phase 5f's fused_row
  and fused_2048 (their 2048-doc workload made once and shared), in
  pairs of ``parent`` and ``graphs``, alternating which runs first; per
  arm serve_2048's docs/s at the SLO, fused_row's walls and p99 apply,
  fused_2048's window p50 and p99;
* **restore**: phase 5d's C_frames session (10,240 docs, its wire frames
  made once and shared) saved and restored, in the arms ``parent``,
  ``graphs``, ``graphs``, ``parent``; per arm the save and restore
  seconds.

Every arm is a process of its own, importing the package and
``chip_smoke.py`` of its checkout.  Needs one NVIDIA card; run from the
repository's root, with the parent unpacked into a directory that
``.gitignore`` lists::

    mkdir -p _checkout/parent && git archive HEAD | tar -x -C _checkout/parent
    python3 scripts/torch_serve_graph_ab.py --parent _checkout/parent [--parts serve,wide]

Prints one ``ab`` JSON line per arm and the summary as its last line.
"""
import argparse
import json
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ARMS = ("parent", "graphs", "eager")


def _import_checkout(root: Path):
    sys.path.insert(0, str(root))
    import chip_smoke as cs

    return cs


def serve_arm(arm: str, cs) -> dict:
    import torch

    device = torch.device("cuda")
    if arm == "eager":
        from peritext_tpu_torch.utils.graphs import GraphCache

        GraphCache.run = lambda cache, key, form, body, inputs, binds=(): body(*inputs)
    from peritext_tpu_torch.obs import RecompileSentinel

    with RecompileSentinel() as sentinel:
        t0 = time.perf_counter()
        report, _ = cs.run_serve_row(device)
        seconds = time.perf_counter() - t0
    return dict(docs_per_s_at_slo=report["docs_per_s_at_slo"],
                rung_p99_ms=[(r["rate_per_s"], r["p99_apply_ms"], r["sustained"])
                             for r in report["rungs"]],
                captures=sum(getattr(sentinel, "captures", {}).values()),
                traced_graphs=report.get("graphs"), seconds=seconds)


class _OpCount:
    """A doc's change in place of its workload: a frame session reads only
    the op count of its workloads."""

    def __init__(self, n: int) -> None:
        self.ops = range(n)


def restore_arm(cs, frames_path: Path) -> dict:
    import torch

    from peritext_tpu_torch.checkpoint import restore_session

    with open(frames_path, "rb") as f:
        wire, nbytes, counts = pickle.load(f)
    workloads = [{"ops": [_OpCount(n)]} for n in counts]
    device = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        ckpts = {"root": Path(tmp)}
        s, out = cs.run_stream_session(device, cs.STREAM, workloads, wire, "C_frames",
                                       wire_bytes=nbytes)
        cs.checkpoint_session(ckpts, "C_frames", s, out)
        digest = ckpts["C_frames"]["digest"]
        del s
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = restore_session(ckpts["C_frames"]["directory"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0  # as phase 5d times it
        restored = r.digest()
    if restored != digest:
        raise AssertionError("restore: the restored digest differs from the saved session's")
    return dict(ops_per_second=out["ops_per_second"],
                save_seconds=ckpts["C_frames"]["save_seconds"], restore_seconds=seconds)


class _Ready:
    """A finished workload job (``run_serve_wide`` takes a pool's)."""

    def __init__(self, value) -> None:
        self.value = value

    def get(self, timeout=None):
        return self.value


def wide_arm(cs, workloads_path: Path) -> dict:
    import torch

    with open(workloads_path, "rb") as f:
        workloads = pickle.load(f)
    device = torch.device("cuda")
    wide, _ = cs.run_serve_wide(device, _Ready(workloads), {})
    row, _ = cs.run_fused_row(device)
    fused, _, _ = cs.run_fused_wide(device, workloads, {"padded": {}, "paged": {}, "ragged": {}})
    return dict(serve_2048_docs_per_s_at_slo=wide["docs_per_s_at_slo"],
                fused_row_walls_s=(row["fused_wall_s"], row["per_session_wall_s"]),
                fused_row_p99_apply_ms=(row["fused_p99_apply_ms"], row["per_session_p99_apply_ms"]),
                fused_2048_window_ms=(fused["window_ms"]["p50"], fused["window_ms"]["p99"]))


def child(arm: str, root: Path, what: str, frames: str) -> int:
    cs = _import_checkout(root)
    if what == "serve":
        row = serve_arm(arm, cs)
    else:
        row = (wide_arm if what == "wide" else restore_arm)(cs, Path(frames))
    print("ab " + json.dumps(dict(what=what, arm=arm, **row)), flush=True)
    return 0


def run_arm(arm: str, what: str, parent: Path, frames: str = "") -> dict:
    root = parent if arm == "parent" else ROOT
    cmd = [sys.executable, str(Path(__file__).resolve()), "--child", arm, "--root", str(root),
           "--what", what, "--frames", frames]
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=str(root))
    rows = [json.loads(line[3:]) for line in proc.stdout.splitlines() if line.startswith("ab ")]
    if proc.returncode != 0 or len(rows) != 1:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
        raise SystemExit(f"{what} arm {arm} failed (exit {proc.returncode})")
    print("ab " + json.dumps(rows[0]), flush=True)
    return rows[0]


def make_wide(path: Path) -> None:
    """The 2048 sessions' workload of phases 5e (b) and 5f, made once."""
    cs = _import_checkout(ROOT)
    from peritext_tpu_torch.testing.devtime import workload

    with open(path, "wb") as f:
        pickle.dump(workload(cs.SERVE["seed"], cs.SERVE["wide"]["docs"],
                             cs.SERVE["wide"]["ops"]), f)


def make_frames(path: Path) -> None:
    """C_frames' wire frames (phase 5d's session), made once for every
    restore arm."""
    cs = _import_checkout(ROOT)
    from peritext_tpu_torch.testing.arrival import build_arrival
    from peritext_tpu_torch.testing.devtime import generate

    cfg = cs.STREAM
    workloads = generate(cfg["seed"], cfg["docs"], cfg["ops"]) + \
        generate(cfg["seed"] + cfg["docs"], cfg["c_docs"] - cfg["docs"], cfg["ops"])
    wire, nbytes = build_arrival(workloads, cfg["rounds"], cfg["seed"], as_frames=True,
                                 wire=cfg["wire"])
    counts = [sum(len(ch.ops) for log in w.values() for ch in log) for w in workloads]
    with open(path, "wb") as f:
        pickle.dump((wire, nbytes, counts), f)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="the second checkout (the parent commit)")
    ap.add_argument("--parts", default="serve,wide,restore",
                    help="comma-separated: serve, wide, restore")
    ap.add_argument("--rounds", type=int, default=5, help="rounds of the three serve arms")
    ap.add_argument("--pairs", type=int, default=3, help="parent/graphs pairs of the wide part")
    ap.add_argument("--child", choices=ARMS, help=argparse.SUPPRESS)
    ap.add_argument("--root", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--what", choices=("serve", "wide", "restore"), help=argparse.SUPPRESS)
    ap.add_argument("--frames", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child, args.root.resolve(), args.what, args.frames)
    if args.parent is None or not (args.parent / "chip_smoke.py").is_file():
        ap.error("--parent must name a checkout holding chip_smoke.py")
    parent = args.parent.resolve()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    parts = set(args.parts.split(","))
    summary = {"card": card, "serve": {a: [] for a in ARMS}, "wide": {"parent": [], "graphs": []},
               "restore": {"parent": [], "graphs": []}}
    for k in range(args.rounds if "serve" in parts else 0):
        for arm in ARMS[k % 3:] + ARMS[:k % 3]:
            row = run_arm(arm, "serve", parent)
            summary["serve"][arm].append(row["docs_per_s_at_slo"])
    if "wide" in parts:
        with tempfile.TemporaryDirectory() as tmp:
            workloads = Path(tmp) / "wide.pkl"
            t0 = time.perf_counter()
            make_wide(workloads)
            print(f"wide: workload made in {time.perf_counter() - t0:.1f} s", flush=True)
            for k in range(args.pairs):
                for arm in (("parent", "graphs") if k % 2 == 0 else ("graphs", "parent")):
                    row = run_arm(arm, "wide", parent, str(workloads))
                    summary["wide"][arm].append(row)
    if "restore" not in parts:
        print(json.dumps(summary), flush=True)
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        frames = Path(tmp) / "c_frames.pkl"
        t0 = time.perf_counter()
        make_frames(frames)
        print(f"restore: C_frames' frames made in {time.perf_counter() - t0:.1f} s", flush=True)
        for arm in ("parent", "graphs", "graphs", "parent"):
            row = run_arm(arm, "restore", parent, str(frames))
            summary["restore"][arm].append((row["save_seconds"], row["restore_seconds"]))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
