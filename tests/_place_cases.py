"""Seeded placement activations shared by the CPU tests of the
placement (test_torch_place.py), the card tests (test_torch_cuda.py) and
``chip_smoke.py``'s place phase: plain inputs, and the same activation
packed into the buffers the wrappers take. Imports only numpy, torch and
the port."""
import numpy as np
import torch

from repro_torch.kernels import sched_place as sp
from repro_torch.kernels import sched_score as ss

TINY = 1e-12
# resource classes by position (True: accelerator): a CPU+GPU machine with
# the classes interleaved, a CPU-only and a GPU-only machine
MACHINES = {
    "both": [False, True, True, False, True, True],
    "cpu": [False] * 4,
    "gpu": [True] * 5,
}


def _q(rng, shape, hi, zeros=0.0):
    """Multiples of 1/8 in [0, hi), a share ``zeros`` of them 0."""
    v = rng.integers(0, int(hi * 8), shape) / 8.0
    if zeros:
        v[rng.random(shape) < zeros] = 0.0
    return v


def dada_case(seed, n=None, accel=None, alpha=None, use_cp=None, area_bound=None,
              max_iters=None, eps_rel=None):
    """A seeded DADA activation: the inputs of both searches. ``n`` ready
    tasks (default 1..8) on a machine of resource classes ``accel`` (by
    position, True for an accelerator); the machine, ``alpha``, ``use_cp``,
    ``area_bound``, ``max_iters`` and ``eps_rel`` default to choices by the
    seed."""
    rng = np.random.default_rng(seed)
    if accel is None:
        accel = MACHINES[("both", "cpu", "gpu")[seed % 3]]
    n_res = len(accel)
    n = int(rng.integers(1, 9)) if n is None else n
    if alpha is None:
        alpha = (0.0, 0.5, 1.0)[(seed // 3) % 3]
    if use_cp is None:
        use_cp = bool((seed // 9) % 2)
    if area_bound is None:
        area_bound = alpha == 0.0 and bool((seed // 18) % 2)
    if max_iters is None:
        max_iters = 1 if seed % 11 == 5 else 30
    p_cpu = (_q(rng, n, 4.0) + 0.125).tolist()
    p_gpu = (_q(rng, n, 2.0) + 0.125).tolist()
    if seed % 7 == 0:  # tasks that are large on one class: dedicated ones
        p_cpu[0] *= 64.0
        p_gpu[-1] *= 64.0
    X = _q(rng, (n, n_res), 1.0, zeros=0.3) if use_cp else np.zeros((n, n_res))
    base = np.where(np.asarray(accel)[None, :], np.asarray(p_gpu)[:, None], np.asarray(p_cpu)[:, None])
    C = (base + X).tolist()
    S = None
    if alpha > 0.0:
        S = _q(rng, (n, n_res), 3.0, zeros=0.6)
        S[rng.random(n) < 0.3] = 0.0  # rows without affinity
    offsets = _q(rng, n_res, 2.0, zeros=0.5).tolist()
    tids = rng.permutation(max(1000, 2 * n))[:n].tolist()
    skey = [-(pc / max(pg, TINY)) for pc, pg in zip(p_cpu, p_gpu)]
    return dict(
        accel=accel, n=n, alpha=alpha, use_cp=use_cp, area_bound=area_bound, C=C, S=S,
        x_max=[max(row) for row in X.tolist()] if use_cp else None,
        p_cpu=p_cpu, p_gpu=p_gpu, tids=tids, offsets=offsets,
        flex_order=sorted(range(n), key=lambda i: (skey[i], tids[i])),
        max_off=max(offsets), sum_max=sum(max(pc, pg) for pc, pg in zip(p_cpu, p_gpu)),
        area=sum(min(pc, pg) for pc, pg in zip(p_cpu, p_gpu)) if area_bound else 0.0,
        off_total=sum(offsets) if area_bound else 0.0,
        eps_rel=(0.01, 1e-3)[seed % 2] if eps_rel is None else eps_rel, max_iters=max_iters,
        cpu_rids=[j for j, a in enumerate(accel) if not a],
        gpu_rids=[j for j, a in enumerate(accel) if a],
    )


# searches that stop partway through a round of the depth-5 midpoint tree:
# by the iteration limit (2..7 probes) or, with a wide tolerance, by the
# stopping rule between two levels; (seed, max_iters, eps_rel)
MID_ROUND = [(seed, max_iters, eps_rel) for max_iters in range(2, 8)
             for eps_rel in (0.01, 0.3) for seed in (max_iters, 40 + max_iters)] + [
    (seed, 30, eps_rel) for eps_rel in (0.02, 0.05, 0.1, 0.2, 0.45) for seed in (7, 19, 23)]


LIVE_KEYS = ("pen", "skip", "n_alive", "pen_top")


def plain_kwargs(case):
    keys = ("C", "S", "x_max", "p_cpu", "p_gpu", "tids", "flex_order", "offsets", "max_off",
            "sum_max", "area", "off_total", "alpha", "eps_rel", "max_iters", "area_bound",
            "cpu_rids", "gpu_rids")
    return {k: case[k] for k in keys + LIVE_KEYS if k in case}


# liveness patterns of live_case: which resource positions are detached and
# which are noticed (a detach announced, not yet fired)
LIVE_KINDS = ("dead0", "one_gpu", "one_cpu", "noticed", "dead_noticed")


def live_case(seed, kind, n=None, accel=None, **kw):
    """A seeded DADA activation on a machine that has lost resources, as
    DADA's host side packs it (repro_torch/core/dada.py, the reference's
    scalar path repro/core/dada.py:132-155, 282-310, 444-447):

    * ``dead0``: resource 0 detached;
    * ``one_gpu`` / ``one_cpu``: every GPU (CPU) detached but one;
    * ``noticed``: one or two resources noticed, under recover;
    * ``dead_noticed``: one detached and one noticed.

    The detached resources leave the CPU and GPU lists and their backlogs
    count 0 (max_off and off_total follow); the preference scan skips
    them and the noticed ones; a noticed column pays its remaining window
    (``pen``, a multiple of 1/8, or 1e-3 for a window about to close);
    the area bound counts the alive resources; the upper bound adds n
    times the largest penalty. ``kw``: dada_case's other choices."""
    if accel is None:
        accel = MACHINES["both"] if kind in ("one_gpu", "one_cpu") else MACHINES[
            ("both", "cpu", "gpu")[seed % 3]]
    case = dada_case(seed, n=n, accel=accel, **kw)
    rng = np.random.default_rng(50_000 + seed)
    n_res = len(accel)
    cpus = [j for j, a in enumerate(accel) if not a]
    gpus = [j for j, a in enumerate(accel) if a]
    dead, noticed = set(), set()
    if kind == "dead0":
        dead = {0}
    elif kind == "one_gpu":
        dead = set(gpus) - {gpus[int(rng.integers(len(gpus)))]}
    elif kind == "one_cpu":
        dead = set(cpus) - {cpus[int(rng.integers(len(cpus)))]}
    elif kind == "noticed":
        noticed = set(rng.choice(n_res, size=1 + seed % 2, replace=False).tolist())
    else:
        dead_j, note_j = rng.choice(n_res, size=2, replace=False).tolist()
        dead, noticed = {dead_j}, {note_j}
    pen = [0.0] * n_res
    for j in noticed:
        pen[j] = 1e-3 if seed % 5 == 0 else float(rng.integers(1, 24)) / 8.0
    offsets = [0.0 if j in dead else o for j, o in enumerate(case["offsets"])]
    case.update(
        offsets=offsets, max_off=max(offsets),
        off_total=sum(offsets) if case["area_bound"] else 0.0,
        cpu_rids=[j for j in cpus if j not in dead], gpu_rids=[j for j in gpus if j not in dead],
        pen=pen, skip=[j in dead or j in noticed for j in range(n_res)],
        n_alive=n_res - len(dead), pen_top=case["n"] * max(pen) if noticed else 0.0,
    )
    return case


def heft_case(seed, n=None, n_res=None):
    """A seeded HEFT activation (priority order, class durations, transfer
    rows, load time stamps) with ties and near-ties of the finish times."""
    rng = np.random.default_rng(10_000 + seed)
    n_res = (3, 6, 14, 40, 70)[seed % 5] if n_res is None else n_res
    n = int(rng.integers(1, 9)) if n is None else n
    n_cls = 2
    cls_of_res = rng.integers(0, n_cls, n_res).tolist()
    # multiples of 1/64: the finish times of the first tasks stay below 1,
    # where the nudges below survive the sums exactly
    durations = ((_q(rng, (n_cls, n), 2.0) + 0.125) / 8).tolist()
    X = _q(rng, (n, n_res), 1.0, zeros=0.4) / 8
    # half the transfers nudged by 1, 2, 3, 4 or 6 times 2**-52 (2.2e-16):
    # finish times within and beyond the 1e-15 margin of each other
    X += rng.choice([1, 2, 3, 4, 6], (n, n_res)) * 2.0 ** -52 * (rng.random((n, n_res)) < 0.5)
    load_ts = (_q(rng, n_res, 3.0) / 8).tolist()
    return dict(X=X.tolist(), order=rng.permutation(n).tolist(), durations=durations,
                cls_of_res=cls_of_res, load_ts=load_ts, now=float(rng.integers(0, 16)) / 64)


def packed_dada(case):
    """The activation packed as the backend packs it: the scorer's
    sections (class durations only: no reads or accesses are needed
    here), the placement section, and a scorer output buffer holding C,
    S and the row maxima."""
    n, n_res = case["n"], len(case["accel"])
    score = ss.ScoreSpec(n=n, nnz_r=0, nnz_w=0, n_u=1, n_res=n_res, want_x=case["use_cp"],
                         want_s=case["S"] is not None, want_c=True)
    live = "pen" in case
    layout = sp.place_layout(sp.PlaceSpec("dada", n, n_res, n_cpu=len(case["cpu_rids"]),
                                          n_gpu=len(case["gpu_rids"]),
                                          area_bound=case["area_bound"], live=live), score)
    buf = np.zeros(layout.n_in, dtype=np.int64)
    empty = (np.zeros(n + 1, dtype=np.int64), np.zeros(0, dtype=np.int64), np.zeros(0))
    ss.pack_activation(buf[:layout.score.n_in], layout.score,
                       reads=empty if case["use_cp"] else None,
                       writes=empty if case["S"] is not None else None,
                       p_cpu=case["p_cpu"], p_gpu=case["p_gpu"])
    sp.pack_dada(buf, layout, **{k: case[k] for k in (
        "offsets", "flex_order", "tids", "max_off", "sum_max", "area", "off_total", "alpha",
        "eps_rel", "max_iters", "cpu_rids", "gpu_rids") + (LIVE_KEYS if live else ())})
    scores = np.zeros(layout.score.n_out)
    mats = ss.unpack_outputs(scores, layout.score)
    mats["C"][:] = case["C"]
    if case["S"] is not None:
        mats["S"][:] = case["S"]
    if case["use_cp"]:
        mats["X_max"][:] = case["x_max"]
    return layout, torch.from_numpy(buf), torch.from_numpy(scores)


def live_heft_case(seed, dead=(0,), noticed=(), n=None, n_res=None):
    """A seeded HEFT activation on a machine that has lost resources: the
    X columns of the ``dead`` positions (modulo n_res) are +inf and the
    ``noticed`` ones pay a notice penalty, as HEFT's pressure fold gives
    them through the scorer's ``x_bias`` (``x + p``)."""
    case = heft_case(seed, n=n, n_res=n_res)
    rng = np.random.default_rng(60_000 + seed)
    n_res = len(case["load_ts"])
    dead = [j % n_res for j in dead]
    X = case["X"]
    for j in noticed:
        p = float(rng.integers(1, 16)) / 64.0
        for row in X:
            row[j % n_res] = row[j % n_res] + p
    for row in X:
        for j in dead:
            row[j] = row[j] + float("inf")
    return case


def packed_heft(case):
    n, n_res = len(case["order"]), len(case["load_ts"])
    score = ss.ScoreSpec(n=n, nnz_r=0, nnz_w=0, n_u=1, n_res=n_res, want_x=True, x_rows=True)
    layout = sp.place_layout(sp.PlaceSpec("heft", n, n_res, n_cls=len(case["durations"])), score)
    buf = np.zeros(layout.n_in, dtype=np.int64)
    ss.pack_activation(buf[:layout.score.n_in], layout.score, reads=(
        np.zeros(n + 1, dtype=np.int64), np.zeros(0, dtype=np.int64), np.zeros(0)))
    sp.pack_heft(buf, layout, **{k: case[k] for k in (
        "order", "durations", "cls_of_res", "load_ts", "now")})
    scores = np.zeros(layout.score.n_out)
    ss.unpack_outputs(scores, layout.score)["X"][:] = case["X"]
    return layout, torch.from_numpy(buf), torch.from_numpy(scores)
