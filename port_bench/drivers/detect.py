"""Driver of the detection cells: ``ContactDetector.infer`` on
device-resident keypoint batches, each call's contacts copied to the host
as ``detect_batch`` returns them.

Set-up makes the model's raw parameters (Linear weights Xavier-uniform,
biases, BatchNorm scales, shifts and running statistics) and ``batches``
keypoint batches on the card from the seed, loads the parameters into the
program's ``ContactMLP`` and builds its detector, and runs one call on each
batch. The window calls the detector on the batches in turn until
``--seconds`` have passed; the fused-MLP kernel must launch once a call.
Each call's window probabilities stay on the card for the check in a
sample of calls drawn from the seed.
"""
from __future__ import annotations

import math
import random
import time

import torch

import harness
import roofline

SAMPLED = 4  # calls whose outputs the check compares, drawn from the seed


def raw_params(cfg: dict, gen, device) -> dict:
    """The model's parameters from ``gen`` in one draw: ``w{i}`` (out, in)
    Xavier-uniform, ``b{i}`` in ±0.05, and for the four BatchNorm layers
    ``gamma{i}`` in [0.8, 1.2], ``beta{i}`` in ±0.1, ``mean{i}`` in ±0.2,
    ``var{i}`` in [0.5, 2]."""
    dims = roofline.mlp_dims(cfg)
    shapes = {}
    for i, (a, b) in enumerate(zip(dims, dims[1:])):
        shapes[f"w{i}"], shapes[f"b{i}"] = (b, a), (b,)
        if i < 4:
            for k in ("gamma", "beta", "mean", "var"):
                shapes[f"{k}{i}"] = (b,)
    u = torch.rand(sum(math.prod(s) for s in shapes.values()), generator=gen, device=device)
    out, at = {}, 0
    for k, s in shapes.items():
        n = math.prod(s)
        v = u[at:at + n].reshape(s)
        at += n
        i = int(k[-1])
        if k.startswith("w"):
            a = math.sqrt(6.0 / (dims[i] + dims[i + 1]))
            v = (2 * v - 1) * a
        elif k.startswith("b"):
            v = (2 * v - 1) * 0.05
        elif k.startswith("gamma"):
            v = 0.8 + 0.4 * v
        elif k.startswith("beta"):
            v = (2 * v - 1) * 0.1
        elif k.startswith("mean"):
            v = (2 * v - 1) * 0.2
        else:
            v = 0.5 + 1.5 * v
        out[k] = v.contiguous()
    return out


def program_model(params: dict, cfg: dict, device):
    """The program's ``ContactMLP`` holding ``params``, in eval mode."""
    from chd_tpu_torch.models import contact_mlp

    mc = cfg["model"]
    model = contact_mlp.ContactMLP(mc["in_dim"], mc["out_dim"]).to(device)
    sd = {}
    for i, li in enumerate(contact_mlp.LINEAR_IDX):
        sd[f"model.{li}.weight"], sd[f"model.{li}.bias"] = params[f"w{i}"], params[f"b{i}"]
    for i, bi in enumerate(contact_mlp.BN_IDX):
        sd[f"model.{bi}.weight"], sd[f"model.{bi}.bias"] = params[f"gamma{i}"], params[f"beta{i}"]
        sd[f"model.{bi}.running_mean"] = params[f"mean{i}"]
        sd[f"model.{bi}.running_var"] = params[f"var{i}"]
    missing, unexpected = model.load_state_dict(sd, strict=False)
    if unexpected or any(not k.endswith("num_batches_tracked") for k in missing):
        raise KeyError(f"the model's keys moved: missing {missing}, unexpected {unexpected}")
    return model.eval()


def detector(model, cfg: dict, device, **override):
    from chd_tpu_torch.contact.infer import ContactDetector

    mc, d = cfg["model"], cfg["detector"]
    kw = dict(window_size=mc["window_size"], pred_size=mc["pred_size"], joint_set=mc["joint_set"],
              conf_thresh=d["conf_thresh"], normalization=d["normalization"],
              classify_thresh=d["classify_thresh"], use_conv=d["use_conv"],
              precision=d["precision"])
    kw.update(override)
    return ContactDetector(model, device=device, **kw)


class Run:
    pass


def setup(cfg: dict, wl: dict, seed: int, device) -> Run:
    traffic = harness.load("traffic", "keypoints")
    run = Run()
    run.cfg, run.wl, run.seed, run.device = cfg, wl, seed, device
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    run.params = raw_params(cfg, gen, device)
    run.batches = [traffic.videos(torch, gen, wl["traffic"], device)
                   for _ in range(wl["traffic"]["batches"])]
    run.det = detector(program_model(run.params, cfg, device), cfg, device)
    for i in range(len(run.batches)):  # packs the kernel's weights and builds it
        call(run, i)
    return run


def call(run: Run, i: int):
    """The timed call: one detection on batch i % batches, its contacts
    on the host. Returns (host contacts, device probabilities)."""
    contacts, probs = run.det.infer(run.batches[i % len(run.batches)])
    return contacts.cpu(), probs


def window(run: Run, seconds: float) -> dict:
    from chd_tpu_torch.ops.fused_mlp import fused_mlp

    pick = random.Random(run.seed)
    run.kept = []
    launches = fused_mlp.launches
    harness.sync(torch, run.device)
    t0 = time.perf_counter()
    n, marks = 0, []
    while True:
        c, p = call(run, n)
        marks.append(time.perf_counter() - t0)
        if len(run.kept) < SAMPLED:
            run.kept.append((n, c, p))
        else:
            j = pick.randrange(n + 1)
            if j < SAMPLED:
                run.kept[j] = (n, c, p)
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    if run.device.type == "cuda" and fused_mlp.launches - launches != n:
        raise RuntimeError(f"the fused-MLP kernel launched {fused_mlp.launches - launches} "
                           f"times in {n} detection calls: a stale path")
    V, F = run.batches[0].shape[:2]
    run.calls, run.elapsed = n, elapsed
    return {"metrics": {"contact_frames_per_s": V * F * n / elapsed},
            "attempted": n, "failed": 0, "calls": n, "elapsed_s": elapsed,
            "info": {"calls": n, "seconds": elapsed, "frames_per_call": V * F,
                     "calls_by_quarter": [sum(1 for m in marks if q * seconds / 4 <= m
                                              < (q + 1) * seconds / 4) for q in range(4)]}}


def trace(run: Run, calls: int = 20) -> dict:
    """``calls`` timed calls under ``torch.profiler``: the kernel's device
    time, the contacts' copies, busy time, and the idle share of a call.

    The idle share is the device's busy time a traced call against the
    window's time a call, not against the traced slice's: the profiler's
    host work a launch (some 60 a call) makes a traced call ~2.5 times as
    long as an untraced one (PERF.md), so the slice's own idle share would
    read the profiler. A call busier than the window's call time fails."""
    prof = harness.profile(torch, lambda: [call(run, i) for i in range(calls)])
    ev = prof.pop("events")
    V, F = run.batches[0].shape[:2]
    busy_call, call_s = prof["busy_s"] / calls, run.elapsed / run.calls
    if busy_call > call_s:
        raise RuntimeError(f"the device was busy {busy_call:.6f} s a traced call, longer than "
                           f"the window's {call_s:.6f} s a call: the trace is miscounted")
    return {"calls_traced": calls,
            "mlp_kernel_s": sum(e["end"] - e["start"] for e in ev
                                if "fused_mlp_kernel" in e["name"]),
            "d2h_s": sum(e["end"] - e["start"] for e in ev
                         if "DtoH" in e["name"] or "Device -> " in e["name"]),
            "flop_per_call": roofline.detect_flop(run.cfg, V, F),
            "mlp_bound_s": roofline.mlp_bound_s(run.cfg, V, F),
            "busy_s": prof["busy_s"], "window_s": prof["window_s"],
            "idle_share": 1.0 - busy_call / call_s,
            "breakdown": {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}}


def compare(run: Run, outputs) -> dict:
    """Outputs ``(call index, host contacts, probabilities)`` against the
    reference on their batch: the widest window-probability gap and the
    largest share of contact labels that differ."""
    ref = harness.load("reference", "detect")
    want = {}
    prob_gap, flips = 0.0, 0.0
    for n, c, p in outputs:
        b = n % len(run.batches)
        if b not in want:
            want[b] = ref.detect(run.batches[b], run.params, run.cfg)
        wc, wp = want[b]
        prob_gap = max(prob_gap, float((p.double() - wp).abs().max()))
        flips = max(flips, float((c.to(wc.device) != wc).double().mean()))
    return {"prob_gap": prob_gap, "contact_flips": flips}


CONTROLS = ("bf16",)  # the reference in one bf16 pass (the configuration states 3)


def check(run: Run, control: str = None) -> list:
    """The numbers compared, each with its limit: the window's sampled
    calls against the reference; with ``control`` (one of ``CONTROLS``)
    the reference at that precision takes the program's place, on every
    batch."""
    run.det = None  # the program's state goes before the reference runs
    torch.cuda.empty_cache()
    if control is None:
        got = compare(run, run.kept)
    else:
        if control not in CONTROLS:
            raise ValueError(f"no control {control!r}; one of {CONTROLS}")
        ref = harness.load("reference", "detect")
        got = compare(run, [(b, *ref.detect(x, run.params, run.cfg, control))
                            for b, x in enumerate(run.batches)])
    lim = run.wl["limits"]
    return [{"name": k, "value": got[k], "limit": lim[k]} for k in ("prob_gap", "contact_flips")]
