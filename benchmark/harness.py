"""One run of one cell of the benchmark of calclens_tpu_torch.

Everything a cell needs is found by name from BENCHMARK.json:

    benchmark/configs/<config>.json    the deployment (RayTraceConfig keys
                                       under "raytrace")
    benchmark/traffic/<traffic>.json   what each plane carries (traffic.py)
    benchmark/cells/<workload>.json    the sample the check compares and its
                                       limits, the traced planes
    benchmark/metrics/<metric>.py      one reader per metric: read(run)
                                       returns the number, or None
    benchmark/kernels/<function>.json  kernel names and operation counts

A run builds the configuration's Raytracer on the device, stages the
traffic's planes from the seed, steps one warm-up plane, then times whole
planes of Raytracer.step until `seconds` have passed (the timed run), or
traces a few planes with torch.profiler and a few more in the Raytracer's
Profile mode (the traced run).  After the window it frees the program's
state and recomputes the last plane for a sample of rays with the plain
reference (reference.py), from the rays' state before that plane and the
plane's particles; the rays' state after init_rays is compared with the
reference's own start.  setup_s leaves out the kernels' nvcc build (once
per checkout), which is printed on its own line.  `run` returns the
result line's object.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

import torch

from . import reference as R
from . import traffic
from .tracing import Trace

# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "calclens_tpu")
ERRORS = ("alpha", "U", "phi", "state", "init")


def read_json(path):
    with open(path) as fp:
        return json.load(fp)


class Cell:
    """A workload of BENCHMARK.json with its files read."""

    def __init__(self, root, workload):
        self.root = root
        self.bench = os.path.join(root, "benchmark")
        self.manifest = read_json(os.path.join(root, "BENCHMARK.json"))
        found = [w for w in self.manifest["workloads"] if w["name"] == workload]
        if not found:
            names = [w["name"] for w in self.manifest["workloads"]]
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json {names}")
        self.workload = found[0]
        self.name = workload
        conf = [c for c in self.manifest["configs"]
                if c["name"] == self.workload["config"]][0]
        self.config = read_json(os.path.join(root, conf["file"]))
        self.traffic = read_json(os.path.join(
            self.bench, "traffic", self.workload["traffic"] + ".json"))
        self.cell = read_json(os.path.join(self.bench, "cells",
                                           workload + ".json"))

    def metrics(self, trace):
        """The metric entries this cell reports in a timed (trace 0) or a
        traced (trace 1) run."""
        e2e = [m for m in self.manifest["end_to_end"]
               if self.name in m.get("workloads", [self.name])]
        if not trace:
            return e2e
        return [m for m in self.manifest["per_layer"]
                if self.name in m["workloads"]]

    def reader(self, name):
        path = os.path.join(self.bench, "metrics", name + ".py")
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


class RunState:
    """What the metric readers read."""

    def __init__(self, cell, cfg):
        self.cell, self.cfg = cell, cfg
        self.bench = cell.bench
        self.setup_s = None
        self.window_s = None
        self.planes = 0
        self.peak_bytes = None
        self.phases = []          # Profile rows of the Profile'd planes
        self.trace = None         # tracing.Trace of the profiled planes
        self.trace_planes = 0

    def phase_mean(self, tag):
        vals = [row[tag] for row in self.phases if tag in row]
        return sum(vals) / len(vals) if vals else None


def card_line():
    """nvidia-smi's name and power limit of the card ('unavailable' when it
    cannot be read)."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    if res.returncode != 0:
        return f"unavailable ({res.stderr.strip()})"
    return res.stdout.strip().splitlines()[0]


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def ray_sample(n_rays, k, seed):
    """The sorted columns of the rays the check compares, from the seed."""
    gen = torch.Generator().manual_seed((int(seed) * 2654435761 + 12345)
                                        % (1 << 63))
    if n_rays <= k:
        return torch.arange(n_rays)
    return torch.unique(torch.randint(0, n_rays, (k,), generator=gen))


def errors(got, ref, wp):
    """Per-ray errors [n] of one plane for the sampled rays.  alpha, U,
    phi: the distance of the ray's field from the reference's over the RMS
    of the reference's field across the sample; state: the largest of
    |n| / wp, |beta|, |A| and |A_prev| distances."""
    def rms(x):
        return float(torch.sqrt((x * x).sum(0).mean()).clamp_min(1e-300))

    d = got - ref
    return {
        "alpha": torch.linalg.vector_norm(d[14:16], dim=0) / rms(ref[14:16]),
        "U": torch.linalg.vector_norm(d[16:20], dim=0) / rms(ref[16:20]),
        "phi": d[20].abs() / rms(ref[20:21]),
        "state": state_error(d, wp),
    }


def state_error(d, scale):
    """Per ray: the largest of the position distance over scale and the
    beta, A and A_prev distances."""
    return torch.stack([
        torch.linalg.vector_norm(d[0:3], dim=0) / scale,
        torch.linalg.vector_norm(d[3:6], dim=0),
        torch.linalg.vector_norm(d[6:10], dim=0),
        torch.linalg.vector_norm(d[10:14], dim=0)]).amax(0)


def sky(cfg, config):
    """(ray box, live box) of the configuration in degrees, as
    reference.Healpix.box_runs takes them: the box the rays fill, and the
    box widened by the configuration's vacuum buffer outside which the
    density map is zero; (None, None) for the full sky."""
    box = (cfg.minRa, cfg.maxRa, cfg.minDec, cfg.maxDec)
    if box[0] <= 0.0 and box[1] >= 360.0 and box[2] <= -90.0 and box[3] >= 90.0:
        return None, None
    b = float(config["vacuum_buffer_deg"])
    return box, (box[0] - b, box[1] + b, box[2] - b, box[3] + b)


def ray_pixels(hp_ray, cols, ray_box, n_rays):
    """The rayOrder pixels of the ray columns cols: the full sky's in RING
    order, or the box's pixels in RING order (the column count checked
    against the box's pixel count)."""
    if ray_box is None:
        if n_rays != hp_ray.npix:
            raise ValueError(f"{n_rays} rays on a sky of {hp_ray.npix} pixels")
        return cols
    pix, n = hp_ray.box_pixel_at(ray_box, cols)
    if n != n_rays:
        raise ValueError(f"{n_rays} rays in a box of {n} pixels")
    return pix


# the controls: the reference put in the program's place in the nearest
# precisions below the float32 the configurations state, (dtype, TF32 on)
CONTROLS = {"bfloat16": (torch.bfloat16, False), "tf32": (torch.float32, True)}


def per_ray_errors(cfg, rec, control=None):
    """The per-ray errors of a recorded plane: rec holds the sampled rays'
    state before it (pre) and after it (post), the plane, its particles
    (pos, mass), the init state's sample (init, init_cols, n_rays), the
    boxes (sky) and the HEALPix grids (hp, hp_ray).  With control None the
    program is judged (the reference in float64, the particles' pixels
    found in the configuration's precision); with a key of CONTROLS that
    control is, the reference computed throughout in bfloat16, or in
    float32 with TF32 matrix products, in the program's place."""
    binL = cfg.maxComvDistance / cfg.NumLensPlanes
    lmax = 3 * (1 << cfg.SHTOrder) - 1
    scal = R.plane_scalars(rec["plane"], cfg.NumLensPlanes,
                           cfg.maxComvDistance, cfg.OmegaM)
    ray_box, live = rec["sky"]
    stated = torch.float64 if cfg.Precision == "f64" else torch.float32
    ref = R.plane_step(rec["hp"], lmax, rec["pre"], rec["pos"], rec["mass"],
                       scal, live, pix_dtype=stated)
    pix = ray_pixels(rec["hp_ray"], rec["init_cols"], ray_box, rec["n_rays"])
    if control is None:
        got, init_got = rec["post"], rec["init"]
    else:
        dtype, tf32 = CONTROLS[control]
        was = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            got = R.plane_step(rec["hp"], lmax, rec["pre"], rec["pos"],
                               rec["mass"], scal, live, dtype=dtype).double()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = was
        init_got = R.initial_state(rec["hp_ray"], pix, binL / 2.0,
                                   dtype).double()
    out = errors(got, ref, scal[2])
    init_ref = R.initial_state(rec["hp_ray"], pix, binL / 2.0)
    out["init"] = state_error(init_got - init_ref, binL / 2.0)
    return out


def numbers(per, names):
    """The check's numbers, by name: <error>_q<percent> is that quantile
    over the sampled rays of the per-ray error, <error>_max its largest."""
    out = {}
    for name in names:
        err, stat = name.rsplit("_", 1)
        v = per[err].double()
        out[name] = float(v.max() if stat == "max"
                          else torch.quantile(v, float(stat[1:]) / 100.0))
    return out


class Stepper:
    """The cell's Raytracer with its staged planes: steps whole planes in
    order (a new lightcone from plane 0 after the last), each plane's
    particles from the staged planes in turn, and records the sampled rays'
    state before the last plane stepped."""

    def __init__(self, cell, cfg, dev, seed, keep_start=False):
        from calclens_tpu_torch.driver import Raytracer

        self.cell, self.cfg, self.dev = cell, cfg, dev
        self.rt = Raytracer(cfg, device=dev)
        self.keep_start = keep_start
        self.start = None
        self.new_seed(seed)

    def new_seed(self, seed):
        """Rays from init_rays, the sample and the staged planes of seed.
        With keep_start, init_rays runs once and later seeds start from a
        copy of its rays (control.py: a box's rays are chosen on the host,
        tens of seconds at rayOrder 14)."""
        self.staged = None
        if self.start is None:
            self.rt.init_rays()
            if self.keep_start:
                self.start = self.rt.rays_packed.clone()
        else:
            self.rt.rays_packed = self.start.clone()
            self.rt.current_plane = 0
        n = self.rt.rays_packed.shape[1]
        self.n_rays = n
        self.cols = ray_sample(n, int(self.cell.cell["check"]["rays"]), seed)
        self.cols_dev = self.cols.to(self.dev)
        self.init = self.rt.rays_packed.index_select(1, self.cols_dev).double()
        self.staged = traffic.stage(self.cell.traffic, seed, self.dev)
        self.plane = 0
        self.last = None

    def step(self):
        rt, p = self.rt, self.plane
        pre = rt.rays_packed.index_select(1, self.cols_dev)
        k = p % len(self.staged)
        pos, mass = self.staged[k]
        mass.fill_(traffic.plane_mass(self.cell.traffic, self.cfg, p))
        rt.step(p, pos, mass)
        self.last = (p, k, pre)
        self.plane += 1
        if self.plane == self.cfg.NumLensPlanes:
            rt.init_rays()
            self.plane = 0

    def record(self, keep_program=False):
        """The last plane's record for per_ray_errors; drops the program's
        state unless keep_program."""
        p, k, pre = self.last
        pos, mass = self.staged[k]
        rec = {"plane": p, "pre": pre.double(),
               "post": self.rt.rays_packed.index_select(1, self.cols_dev).double(),
               "pos": pos, "mass": mass, "init": self.init,
               "init_cols": self.cols.to(self.dev), "n_rays": self.n_rays,
               "sky": sky(self.cfg, self.cell.config),
               "hp": R.Healpix(self.cfg.SHTOrder, self.dev),
               "hp_ray": R.Healpix(self.cfg.rayOrder, self.dev)}
        if not keep_program:
            self.rt = None
            self.staged = None
            if self.dev.type == "cuda":
                torch.cuda.empty_cache()
        return rec


def make_config(cell):
    from calclens_tpu_torch.config import RayTraceConfig

    return RayTraceConfig(**cell.config["raytrace"]).finalize()


def run(root, workload, seed, seconds, trace, device, t_start, log=print):
    """One run of a cell; returns the result line's object.  log takes the
    lines printed before it."""
    from calclens_tpu_torch import _ext

    dev = torch.device(device)
    cell = Cell(root, workload)
    cfg = make_config(cell)
    st = RunState(cell, cfg)
    chk = cell.cell["check"]
    log(f"card: {card_line() if dev.type == 'cuda' else 'cpu'}")

    sp = Stepper(cell, cfg, dev, seed)
    sp.step()                                               # warm-up plane
    _sync(dev)
    setup_peak = (torch.cuda.max_memory_allocated(dev)
                  if dev.type == "cuda" else 0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    # the kernels' nvcc build, once per checkout, is recorded apart
    build_s = _ext.build_seconds or 0.0
    st.setup_s = time.time() - t_start - build_s
    log(f"kernel build s: {_ext.build_seconds}  (None: already built; "
        f"not in setup_s)")

    if not trace:
        _ext.reset_launches()
        t0 = time.perf_counter()
        while True:
            sp.step()
            st.planes += 1
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(dev)
        st.window_s = time.perf_counter() - t0
        log(f"rays/s: {sp.n_rays * st.planes / st.window_s}  rays "
            f"{sp.n_rays}  planes {st.planes}  window s {st.window_s}")
        log("launches per plane: " + json.dumps(
            {k: v / st.planes for k, v in _ext.launches.items() if v}))
    else:
        tr = cell.cell.get("trace", {})
        out_dir = os.path.join(root, "bench_out", workload)
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"trace.{seed}.json")
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        n_prof = int(tr.get("profiler_planes", 3))
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("bench_window"):
                for _ in range(n_prof):
                    sp.step()
                _sync(dev)
        prof.export_chrome_trace(path)
        st.trace = Trace.load(path, keep=path[:-5] + ".device.json.gz")
        st.trace_planes = n_prof
        log(f"trace: {path}  window s {st.trace.window_s}  busy s "
            f"{st.trace.busy_s}")
        cfg.Profile = True
        for _ in range(int(tr.get("profile_planes", 3))):
            p0 = sp.plane
            sp.step()
            st.phases.append(dict(sp.rt.phase_rows)[p0])
        cfg.Profile = False
        log("profile rows: " + json.dumps(st.phases))
        st.planes = n_prof + len(st.phases)
    st.peak_bytes = (torch.cuda.max_memory_allocated(dev)
                     if dev.type == "cuda" else 0)
    memory_peak = max(setup_peak, st.peak_bytes)

    # the window has closed: the check, of the program's outputs only
    rec = sp.record()
    del sp
    t_ref = time.perf_counter()
    per = per_ray_errors(cfg, rec)
    _sync(dev)
    limits = chk["limits"]
    nums = numbers(per, limits)
    log(f"reference s: {time.perf_counter() - t_ref}  plane {rec['plane']}"
        f"  rays {len(rec['init_cols'])}")

    metrics = {}
    for m in cell.metrics(trace):
        v = cell.reader(m["name"])(st)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    check = {k: {"value": nums[k], "limit": limits[k]} for k in limits}
    correct = all(c["value"] <= c["limit"] for c in check.values())
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else dev.type),
        "count": 1,
        "memory_peak_bytes": int(memory_peak),
    }
    out = {"correct": correct, "attempted": st.planes,
           "failed": 0 if correct else 1, "metrics": metrics,
           "device": device_info}
    if trace:
        device_info["busy_s"] = st.trace.busy_s
        device_info["window_s"] = st.trace.window_s
        out["breakdown"] = {"device_ops": st.trace.device_ops(),
                            "idle_gaps": st.trace.idle_gaps()}
    out["check"] = check
    return out
