"""Runs one cell of the port's benchmark once and prints its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell (``workloads`` in BENCHMARK.json at the checkout's root) names a
configuration (``portbench/configs/<config>.json``) and a traffic mix
(``portbench/mixes/<mix>.json``, with ``portbench/mixes/<mix>.py`` where
the mix brings its own streams or loop: ``make_stream``, ``window``); its
per-layer metrics are readers in ``portbench/metrics/<metric>.py``. The
configuration names its model family (``"family"``, ``insmos`` where
absent): ``portbench/families/<family>.py`` gives everything that depends
on the architecture (:func:`load_family`). Set-up builds the family's
model on the benchmark's weights, starts the scan generator in a child
process on a core of its own and steps through ``warm_steps`` steps,
which fills the window and builds the kernels. The
window then steps for ``--seconds``, by default in a closed loop
(:func:`closed_loop`): each step pushes every stream's next scan and
fetches every stream's outputs to the host before the next. It closes at
the first step that ends at or after ``--seconds``; ``scans_per_s`` is
every scan of the window over the window's length, ``scan_latency_p90_ms``
the 90th percentile over all of them (push to outputs on the host). The
time spent taking scans from the generator is counted in the window and
reported; a run in which it passes ``FEED_SHARE_MAX`` of the window is
refused, since the generator and not the program set its pace. With
``--trace 1`` the window is followed by ``profile_steps`` steps under
``torch.profiler``, and the per-layer metrics are printed instead of the
end-to-end ones.

After the window, a sample of its steps drawn from ``--seed`` is held
against the family's plain reference (``portbench/reference``), each of
the family's numbers beside its limit (``check`` in the configuration
file): ``compare`` (step, stream) pairs, the streams taken in turn so that
every stream has a step compared where ``compare`` >= the streams. A scan
on which the program's own gates fired (for InsMOS: points or sites
dropped, a span-conv row left uncovered) or that took a recovery step is
served but inexact: it is not compared, and is counted in the result's
``inexact`` and the per-layer ``inexact_scan_pct``; in a mode that
carries state (InsMOS's fixed frame) so is every step whose window holds
such a step. ``failed`` counts the window's scans whose outputs never
reached the host.

The last line of standard output is the result (JSON); the last lines of
standard error give each compared number and its limit. The exit code is
not 0, and no result is printed, when there is no CUDA device or fewer
than the cell asks for, when the program is missing, or when a module of
jax, jaxlib, flax or the JAX package was loaded.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import check, stats, traffic  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "insmos_tpu")
FEED_SHARE_MAX = 0.01


class Refused(Exception):
    """A run that cannot give a result: the message says why."""


# ------------------------------------------------------------------ manifest
def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def cell_files(root: str, workload: str):
    """(cell, configuration document, mix, per-layer metric entries) of a
    workload, found by name."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg_doc = load_json(os.path.join(root, cfg_entry["file"]))
    mix = load_mix(cell["traffic"])
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", [workload])]
    return cell, cfg_doc, mix, layer


def load_mix(name: str, mixes_dir: str | None = None) -> dict:
    """A traffic mix by name: its parameters (``<mix>.json``), and in
    ``hooks_file`` the path of its ``<mix>.py`` where there is one."""
    d = mixes_dir or os.path.join(HERE, "mixes")
    mix = load_json(os.path.join(d, name + ".json"))
    hooks = os.path.join(d, name + ".py")
    mix["hooks_file"] = hooks if os.path.isfile(hooks) else None
    return mix


def _load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(name: str):
    """The reader module of one per-layer metric."""
    return _load_module(os.path.join(HERE, "metrics", name + ".py"),
                        f"portbench_metric_{name}")


def family_name(cfg_doc: dict) -> str:
    """The model family a configuration document names, ``insmos`` where
    it names none."""
    return cfg_doc.get("family", "insmos")


def load_family(name: str, families_dir: str | None = None):
    """The module of a model family (``families/<family>.py``). It gives:

    - ``build(cd, device) -> (model, state)``: the program's model and the
      benchmark's weights (``cd`` is the document's ``config``);
    - ``Server(cd, model, mix, device)``: the program's pipeline for the
      mix's ``entry`` and ``streams`` (``S``), with ``push(item) -> out``
      (item: one (scan, tf) a stream), ``fetch(out, item)`` (every
      stream's host outputs), ``gates(out)`` (the step's gate counters,
      device tensors, one row a stream) and ``recoveries`` (the program's
      recovery steps so far, each inexact on every stream);
    - ``INEXACT``: the gates that make a scan inexact; ``CARRIED``: {gate:
      its leading counters that a window carries into later steps};
    - ``window(cd) -> (W, carries, (most points a scan, fixed frame,
      voxel edge))``: the steps in the window, whether the mode carries
      state, the scan producer's arguments;
    - ``reference(cd, state, scans, tfs, *, device, dtype, tape)``: one
      step of the plain reference; ``CONTROL_DTYPE``, the control's dtype;
    - ``NAMES`` and ``compare(pairs, cd)``: the compared numbers, and all
      of them with ``boxes_compared`` over [(program, reference)] outputs;
    - ``step_work(cd, state, scans, tfs, device)``: a stream's step of
      useful work (:func:`portbench.work.step_work`);
    - ``RANGES``: (model method, host range, idle-gap label), the ranges
      a traced run wraps around the model."""
    d = families_dir or os.path.join(HERE, "families")
    return _load_module(os.path.join(d, name + ".py"),
                        f"portbench_family_{name}")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


# ---------------------------------------------------------------- the run
class Steps:
    """A family's server for one mix, and what each step took and gave:
    inputs by stream, the outputs fetched, the gate counters."""

    def __init__(self, fam, server):
        self.fam = fam
        self.srv = server
        self.S = server.S
        self.inputs = []  # per step: [(scan, tf)] a stream
        self.outputs = []  # per step: [host outputs] a stream
        self.gates = []  # per step: the device gate counters
        self.recovery = []  # per step: recovery steps taken
        self.fetch_range = None

    def step(self, item):
        before = self.srv.recoveries
        out = self.srv.push(item)
        with self._fetch():
            host = self.srv.fetch(out, item)
        self.inputs.append(item)
        self.outputs.append(host)
        self.gates.append(self.srv.gates(out))
        self.recovery.append(self.srv.recoveries - before)

    def _fetch(self):
        if self.fetch_range is None:
            return contextlib.nullcontext()
        return self.fetch_range("pb.fetch")

    def _rows(self, v):
        import torch

        v = v.detach().to("cpu", torch.int64)
        return v.reshape(self.S, -1) if self.S > 1 else v.reshape(1, -1)

    def bad_steps(self, carried_only: bool = False) -> list[list[bool]]:
        """Per step and stream: one of the family's ``INEXACT`` gates
        fired, or the step was a recovery step. With ``carried_only``,
        only what a carrying mode passes on to later steps: the leading
        counters of each gate that the family's ``CARRIED`` names."""
        import torch

        out = []
        for g, rec in zip(self.gates, self.recovery):
            per = torch.zeros(self.S, dtype=torch.int64)
            for k in self.fam.INEXACT:
                if k not in g:
                    continue
                v = self._rows(g[k])
                if carried_only:
                    v = v[:, :self.fam.CARRIED.get(k, 0)]
                per += v.sum(dim=1)
            out.append([bool(x > 0) or rec > 0 for x in per.tolist()])
        return out

    def gate_counts(self, steps) -> dict:
        """Scans of ``steps`` on which each ``INEXACT`` gate fired."""
        counts = {}
        for s in steps:
            for k, v in self.gates[s].items():
                if k in self.fam.INEXACT:
                    n = int((self._rows(v).sum(dim=1) > 0).sum())
                    counts[k] = counts.get(k, 0) + n
        return counts


def failed_steps(bad, carried, W: int):
    """Per step and stream, whether its outputs are not compared: its own
    gates, and (``carried`` not None: the fixed-frame mode) what an earlier
    step of its window carried into it."""
    if carried is None:
        return bad
    out = []
    for s in range(len(bad)):
        lo = max(0, s - W + 1)
        out.append([bad[s][i] or any(carried[u][i] for u in range(lo, s))
                    for i in range(len(bad[s]))])
    return out


def compared_steps(bad, window, seed: int, n: int):
    """Up to n (step, stream) of the window whose outputs are compared,
    drawn from the seed among those that did not fail, the streams taken
    in turn (in an order drawn from the seed): where n >= the streams,
    every stream with a step that did not fail has one compared. Sorted
    by step."""
    window = list(window)
    if not window:
        return []
    S = len(bad[window[0]])
    rng = traffic.np.random.default_rng([int(seed), 4])
    left = [[s for s in window if not bad[s][i]] for i in range(S)]
    order = rng.permutation(S).tolist()
    picked = []
    for k in range(n):
        i = order[k % S]
        if left[i]:
            s = left[i].pop(int(rng.integers(len(left[i]))))
            picked.append((s, i))
    return sorted(picked)


def closed_loop(steps: "Steps", get, seconds: float) -> dict:
    """The default window: each step takes every stream's next scan
    (``get``), pushes them and fetches every output to the host before
    the next, until the first step that ends at or after ``seconds``.
    Returns each scan's latency (push to outputs on the host, s), each
    step's end and the window's length (s from its start), and the time
    spent in ``get`` (s)."""
    lat, ends, feed = [], [], 0.0
    t0 = time.perf_counter()
    while True:
        tg = time.perf_counter()
        item = get()
        ts = time.perf_counter()
        feed += ts - tg
        steps.step(item)
        te = time.perf_counter()
        lat.extend([te - ts] * steps.S)
        ends.append(te - t0)
        if te - t0 >= seconds:
            break
    return dict(latency_s=lat, ends_s=ends, window_s=te - t0, feed_s=feed)


def reference_window(steps: Steps, s: int, i: int, W: int):
    """Stream i's scans and transforms of the W steps that end at step s,
    oldest first, None before the stream began."""
    scans, tfs = [], []
    for u in range(s - W + 1, s + 1):
        if u < 0:
            scans.append(None)
            tfs.append(None)
        else:
            scans.append(steps.inputs[u][i][0])
            tfs.append(steps.inputs[u][i][1])
    return scans, tfs


def run(cfg_doc: dict, mix: dict, seed: int, seconds: float, trace: bool,
        layer_metrics: list, device: str = "cuda", t_start: float = None,
        child_cpu: int | None = None, control: str | None = None,
        families_dir: str | None = None):
    """One run of a cell; returns the result object and the check's lines.
    ``device`` "cpu" serves the tests (no device numbers then).
    ``child_cpu``: the core the scan generator runs on alone. ``control``:
    a dtype; the reference computed in it is also held against the
    float32 reference on the compared steps, and its numbers are returned
    under ``control`` (the check's upper readings). ``families_dir``: where
    the configuration's family is found (``portbench/families``)."""
    import torch

    t_start = _T_START if t_start is None else t_start
    on_card = device != "cpu"
    fam = load_family(family_name(cfg_doc), families_dir)
    cd = cfg_doc["config"]
    W, carries, producer_args = fam.window(cd)
    S = mix["streams"]

    def sync():
        if on_card:
            torch.cuda.synchronize()

    hooks = traffic.load_hooks(mix.get("hooks_file"))
    window_fn = getattr(hooks, "window", None) or closed_loop
    prod = traffic.Producer(traffic.stream_seeds(seed, mix), mix,
                            *producer_args, mix["max_steps"],
                            mix["ahead"], cpu=child_cpu)
    try:
        model, state = fam.build(cd, device)
        steps = Steps(fam, fam.Server(cd, model, mix, device))
        if trace:
            _wrap_ranges(model, fam.RANGES)
        for _ in range(mix["warm_steps"]):
            steps.step(prod.get())
        sync()
        setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start

        # ---------------------------------------------------- the window
        first = len(steps.inputs)
        win = window_fn(steps, prod.get, seconds)
        lat, ends, window_s = win["latency_s"], win["ends_s"], win["window_s"]
        n_window = len(steps.inputs) - first
        sync()
        window_peak = torch.cuda.max_memory_allocated() if on_card else 0

        record = None
        if trace:
            from torch.autograd.profiler import record_function

            from portbench import trace as trace_mod

            steps.fetch_range = record_function
            prof_first = len(steps.inputs)
            record = trace_mod.profile(
                lambda: (steps.step(prod.get()), sync()),
                mix["profile_steps"], [r[1:] for r in fam.RANGES])
            prof_steps = list(range(prof_first, len(steps.inputs)))
            steps.fetch_range = None
    finally:
        prod.close()

    bad = failed_steps(steps.bad_steps(),
                       steps.bad_steps(True) if carries else None, W)
    window = range(first, first + n_window)
    failed_by = steps.gate_counts(window)
    n_inexact = sum(sum(bad[s]) for s in window)
    attempted = n_window * S
    n_failed = attempted - len(lat)
    memory_peak = max(setup_peak, window_peak)
    pipe_outputs = steps.outputs
    del steps.srv, model
    steps.gates = []
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # --------------------------------------------- the check, after the window
    t_cmp = time.perf_counter()
    picked = compared_steps(bad, window, seed, mix["compare"])
    n_cmp = len(picked)
    pairs, ctrl = [], []
    for s, i in picked:
        scans, tfs = reference_window(steps, s, i, W)
        r = fam.reference(cd, state, scans, tfs, device=device)
        pairs.append((pipe_outputs[s][i], r))
        if control:
            ctrl.append((fam.reference(cd, state, scans, tfs, device=device,
                                       dtype=control), r))
    numbers = fam.compare(pairs, cd)
    compare_s = time.perf_counter() - t_cmp
    limits = cfg_doc.get("check", {}).get("limits")
    if limits is None:
        correct, shown = False, {n: {"value": numbers[n], "limit": None}
                                 for n in fam.NAMES}
    else:
        correct, shown = check.verdict(numbers, limits, fam.NAMES)
    correct = correct and n_cmp > 0

    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": n_failed, "inexact": n_inexact}
    if not trace:
        metrics = {
            "scans_per_s": {"value": attempted / window_s, "unit": "scans/s"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
        if S == 1:
            metrics["scan_latency_p90_ms"] = {
                "value": stats.percentile(lat, 90) * 1e3, "unit": "ms"}
        result["metrics"] = metrics
    else:
        t_work = time.perf_counter()
        work = _profiled_work(fam, cd, state, steps, prof_steps, W, device)
        work["seconds"] = time.perf_counter() - t_work
        rec = dict(trace=record, streams=S, scans=len(prof_steps) * S,
                   window_step_s=window_s / n_window,
                   window_peak_bytes=window_peak, work=work,
                   on_card=on_card, inexact_share=n_inexact / attempted)
        metrics = {}
        for m in layer_metrics:
            mod = load_metric(m["name"])
            v = mod.read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = metrics
        device_info["busy_s"] = record["busy_s"]
        device_info["window_s"] = record["window_s"]
        result["breakdown"] = {"device_ops": record["device_ops"],
                               "idle_gaps": record["idle_gaps"]}
        result["profile"] = {
            "profiled_step_s": record["window_s"] / record["steps"],
            "window_step_s": window_s / n_window,
            "launches_per_step": record["activities"] / record["steps"],
            "charged_s": record["charged_s"], "work_s": work["seconds"]}
    half = len(ends) // 2
    result["window"] = {
        "steps": n_window, "feed_s": win["feed_s"],
        "feed_share": win["feed_s"] / window_s,
        "step_ms_quartiles": [q * 1e3 for q in stats.quartiles(lat[::S])],
        "halves_scans_per_s": [half * S / ends[half - 1],
                               (len(ends) - half) * S
                               / (ends[-1] - ends[half - 1])]
        if half else None}
    result["device"] = device_info
    result["compared"] = {"steps": n_cmp,
                          "streams": len({i for _, i in picked}),
                          "boxes": numbers["boxes_compared"],
                          "numbers": numbers, "seconds": compare_s,
                          "failed_by": failed_by, "window_s": window_s}
    if control:
        result["control"] = fam.compare(ctrl, cd)
    result["check"] = {n: [v["value"], v["limit"]] for n, v in shown.items()}
    lines = [f"check {n}: {v['value']!r} limit {v['limit']!r}"
             for n, v in shown.items()]
    return result, lines


def _wrap_ranges(model, ranges):
    """Host ranges around methods of the model instance, active only under
    the profiler: ``ranges`` holds (method, range name, gap label)."""
    from torch.autograd.profiler import record_function

    def wrapped(fn, name):
        def call(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return call

    for method, name, _ in ranges:
        setattr(model, method, wrapped(getattr(model, method), name))


def _profiled_work(fam, cd, state, steps, prof_steps, W, device):
    """Useful work of the profiled steps, by the benchmark's rulebook:
    FLOPs per step (all streams) and the span convs' bound."""
    from portbench import work as work_mod

    flops, span_bound, span_flops = 0.0, 0.0, 0.0
    for s in prof_steps:
        for i in range(steps.S):
            scans, tfs = reference_window(steps, s, i, W)
            w = fam.step_work(cd, state, scans, tfs, device)
            flops += w["flops"]
            span_bound += w["span"]["bound_s"]
            span_flops += w["span"]["flops"]
    n = max(len(prof_steps), 1)
    return dict(flops_per_step=flops / n, span_bound_s=span_bound,
                span_flops=span_flops, peak_flops=work_mod.PEAK_FLOPS)


# -------------------------------------------------------------------- main
def pin_cores():
    """Gives the scan generator the last core of this process's set and
    keeps this process (and torch's threads, sized from it at torch's
    import) off it. Returns that core, or None with fewer than 4 cores."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) < 4:
        return None
    os.sched_setaffinity(0, cores[:-1])
    return cores[-1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell, cfg_doc, mix, layer = cell_files(ROOT, args.workload)
        child_cpu = pin_cores()
        try:
            import torch
        except ImportError as e:
            raise Refused(f"no torch: {e}") from e
        if not torch.cuda.is_available():
            raise Refused("no CUDA device")
        if torch.cuda.device_count() < cell["chips"]:
            raise Refused(f"{torch.cuda.device_count()} CUDA devices, the "
                          f"cell asks for {cell['chips']}")
        try:
            import insmos_tpu_torch  # noqa: F401
        except ImportError as e:
            raise Refused(f"the program is missing: {e}") from e
        result, lines = run(cfg_doc, mix, args.seed, args.seconds,
                            bool(args.trace), layer, child_cpu=child_cpu)
        share = result["window"]["feed_share"]
        if share > FEED_SHARE_MAX:
            raise Refused(f"taking scans from the generator held {share:.2%}"
                          f" of the window (over {FEED_SHARE_MAX:.0%})")
    except Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded {', '.join(found)} (the port and the "
              "benchmark must not)", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
