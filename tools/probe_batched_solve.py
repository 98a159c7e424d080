"""Which route of a batched 6x6 SPD solve a CUDA graph can capture, and
what each costs: the solve of ``geom/linear.py::solve_spd`` at the GN
step's shapes (one system per video, V = 2 and 8).

Each route runs in a child process of its own (a refused capture can leave
the CUDA context unusable):

- ``default``: ``cholesky_ex`` + ``cholesky_solve`` (PyTorch routes a
  batched ``cholesky_solve`` to MAGMA);
- ``cusolver``: the same under ``preferred_linalg_library("cusolver")``
  (potrsBatched);
- ``trsm``: ``cholesky_ex`` + two ``linalg.solve_triangular``, the
  port's ``solve_spd``;
- ``unrolled``: the JAX package's unrolled Cholesky as tensor ops
  (:func:`solve_unrolled`).

For each: whether 32 solves in a row (one GN frame's iterations) capture,
the captured graph's kernel nodes, the replay's device time per solve
(CUDA events over 50 replays), and the largest difference of the replayed
solution from the eager one and from a float64 solve on the CPU.  Prints
one JSON line per route and batch.

With ``--videos``, how far each route parts a batched video from its
single-video run: chip_smoke phase 9's first interval (init and 7
frames) of its 8 videos of run_gn at 480x270 under the parity config,
batched and one by one, every frame step graphed, with ``solve_spd``
replaced by the route; one JSON line per route with each video's max
|pose component difference| (phase 9 holds it to 2e-3).  The routes
there: ``solve_spd`` (the port's: ``trsm``, with one system solved as a
batch of two, so cuSOLVER's batched factorization runs for one video
too), ``trsm_one`` (``trsm`` with one system factored alone, by potrf),
``unrolled`` (for one system too, so the solve's arithmetic is the same
whatever the batch) and ``fork`` (the unrolled form for a batch,
``cholesky_solve`` for one system).

    python tools/probe_batched_solve.py            # every route, V = 2, 8
    python tools/probe_batched_solve.py --videos   # batched against single
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ROUTES = ("default", "cusolver", "trsm", "unrolled")
BATCHES = (2, 8)
SOLVES = 32          # GN iterations of one frame: 4 levels of 8


def solve_unrolled(A, b):
    """The JAX package's solve: the Cholesky factorization and the two
    substitutions unrolled into scalar operations on the batch slices."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(s) if i == j else s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def _solve(route):
    from egomotion_with_local_loop_closures_tpu_torch.geom import linear

    def chol(A, b):
        L, info = torch.linalg.cholesky_ex(A)
        x = torch.cholesky_solve(b.unsqueeze(-1), L).squeeze(-1)
        return torch.where((info == 0)[..., None], x, float("nan"))

    return {"default": chol, "cusolver": chol, "trsm": linear.solve_spd,
            "unrolled": solve_unrolled}[route]


def child(route: str) -> None:
    from egomotion_with_local_loop_closures_tpu_torch.runtime import graphs
    if route == "cusolver":
        torch.backends.cuda.preferred_linalg_library("cusolver")
    solve = _solve(route)
    dev = torch.device("cuda")
    for V in BATCHES:
        rng = np.random.default_rng(V)
        M = rng.normal(size=(V, 6, 6))
        A64 = M @ np.swapaxes(M, -1, -2) + 0.5 * np.eye(6)
        b64 = rng.normal(size=(V, 6))
        ref = np.linalg.solve(A64, b64[..., None])[..., 0]
        A = torch.tensor(A64, dtype=torch.float32, device=dev)
        b = torch.tensor(b64, dtype=torch.float32, device=dev)

        def body():
            x = b
            for _ in range(SOLVES):
                x = solve(A, x / x.abs().max())
            return x

        row = {"route": route, "videos": V, "solves": SOLVES}
        eager = body()
        one = solve(A, b)
        torch.cuda.synchronize()
        row["eager_err_vs_float64"] = float(np.abs(
            one.cpu().numpy() - ref).max())
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            with torch.cuda.graph(g, stream=side):
                out = body()
        except Exception as e:                    # the finding itself
            row["captured"] = False
            row["error"] = f"{type(e).__name__}: {str(e).splitlines()[0]}"
            print(json.dumps(row), flush=True)
            return
        row["captured"] = True
        row["nodes"] = graphs._graph_nodes(g)[0]
        g.instantiate()
        g.replay()
        torch.cuda.synchronize()
        row["replay_vs_eager_max_abs"] = float((out - eager).abs().max())
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(50):
            g.replay()
        t1.record()
        torch.cuda.synchronize()
        row["replay_us_per_solve"] = 1e3 * t0.elapsed_time(t1) / (
            50 * SOLVES)
        row["nodes_per_solve"] = row["nodes"].get("kernel", 0) / SOLVES
        print(json.dumps(row), flush=True)


def _video_routes():
    from egomotion_with_local_loop_closures_tpu_torch.geom import linear

    def trsm_one(A, b):
        L, info = torch.linalg.cholesky_ex(A)
        y = torch.linalg.solve_triangular(L, b.unsqueeze(-1), upper=False)
        x = torch.linalg.solve_triangular(L.mT, y, upper=True).squeeze(-1)
        return torch.where((info == 0)[..., None], x, float("nan"))

    def fork(A, b):
        if A.shape[:-2].numel() > 1:
            return solve_unrolled(A, b)
        return _solve("default")(A, b)

    return {"solve_spd": linear.solve_spd, "trsm_one": trsm_one,
            "unrolled": solve_unrolled, "fork": fork}


def videos() -> None:
    """Phase 9's first interval, batched and one video at a time, under
    each route of ``solve_spd``."""
    from egomotion_with_local_loop_closures_tpu_torch.config import (
        ELLCConfig, PARITY_OVERRIDES)
    from egomotion_with_local_loop_closures_tpu_torch.geom import linear
    from egomotion_with_local_loop_closures_tpu_torch.parallel import sharded
    from egomotion_with_local_loop_closures_tpu_torch.runtime import (
        graphs, pipeline)
    cfg = ELLCConfig().replace(**PARITY_OVERRIDES)
    frames = np.load(os.path.join(ROOT, "reference_build", "run_gn",
                                  "frames_480x270.npz"))["frames"]
    K, V, stride = cfg.keyframe_interval, 8, 64
    vids = np.stack([frames[stride * v:stride * v + K] for v in range(V)])
    dev = torch.device("cuda")
    for name, fn in list(_video_routes().items()):
        linear.solve_spd = fn
        graphs.release()
        st = sharded.batched_init(vids[:, 0], cfg, dev)
        _, out = sharded.batched_process_interval(st, vids[:, 1:], cfg)
        batched = out.pose_wrt_world.cpu().numpy()
        gaps, rerun = [], None
        for v in range(V):
            s1 = pipeline.init_pipeline(vids[v, 0], cfg, dev)
            _, o1, _ = pipeline.process_interval(s1, list(vids[v, 1:]), cfg)
            one = o1.pose_wrt_world.cpu().numpy()
            gaps.append(float(np.abs(one - batched[v]).max()))
            if v == V - 1:
                s1 = pipeline.init_pipeline(vids[v, 0], cfg, dev)
                _, o2, _ = pipeline.process_interval(s1, list(vids[v, 1:]),
                                                     cfg)
                rerun = float(np.abs(o2.pose_wrt_world.cpu().numpy()
                                     - one).max())
        print(json.dumps({"route": name, "max_pose_diff_per_video": gaps,
                          "video_7_single_rerun_diff": rerun}), flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--route"]:
        child(sys.argv[2])
        return 0
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--videos"]:
        videos()
    else:
        for route in ROUTES:
            _route_child(route)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(gpu)
    return 0


def _route_child(route: str) -> None:
    """One route's probe in a process of its own."""
    p = subprocess.run([sys.executable, __file__, "--route", route],
                       capture_output=True, text=True, timeout=300)
    sys.stdout.write(p.stdout)
    if p.returncode != 0:
        tail = p.stderr.strip().splitlines()[-1:] or [""]
        print(json.dumps({"route": route, "rc": p.returncode,
                          "stderr": tail[0]}))


if __name__ == "__main__":
    sys.exit(main())
