"""One run of one benchmark cell of ``fslr_tpu_torch`` on one card.

    python3 -m benchmark.run --workload NAME --seed N --seconds S \
        --trace 0|1

from the root of a checkout.  The cell (an entry of ``BENCHMARK.json``'s
``workloads``) names a configuration, ``benchmark/configs/<name>.json``,
and a traffic mix, ``benchmark/mixes/<name>.json``; per-layer metrics are
``benchmark/metrics/<name>.py`` and a kernel's work
``benchmark/work/<kernel>.py``, each found by its name.

Set-up (``setup_s``, from the process's start to the window's): torch and
the card, the configuration's reference FASTA (written once into
``benchmark/_cache/<config>/``, where the program keeps its seed-index
cache beside it), the samples of the mix made from ``--seed`` and
written as gzip FASTQ folders under ``TMPDIR`` (for a configuration
with ``"input": "mappings"``, as the ``mappings.bed`` and BAM header that
an earlier run left, which ``--skip-alignment`` clusters anew), and one
warm-up ``run_pipeline`` on one more sample of the same mix, which builds
the program's kernels on a checkout's first run.

The window runs the samples back to back, each through
``fslr_tpu_torch.pipeline.run_pipeline`` with the configuration that
``fslr_tpu_torch.cli.config_from_args`` builds from the configuration's
CLI arguments, as ``fslr-tpu-torch`` does; a sample started within
``--seconds`` runs to its end.  ``reads_per_s`` is the input reads of
every sample (the reads of its mappings, where those are the input) over
the time from the window's start to the last sample's end.  With
``--trace 1`` the window runs under ``torch.profiler`` and the per-layer
metrics are printed instead.  After the window ``judge.py`` decides
``correct``: it holds the window's artifacts to the reads' planted truth
and the reference FASTA (``judge_clusters.py``: the cluster beds to the
mappings and the groups planted in them).

The last line of standard output is the result's JSON object; the
pipeline's own output goes to standard error.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, '_cache')
WINDOW = 'benchmark.window'
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'fslr_tpu')


def _named(kind: str, name: str, suffix: str) -> str:
    """The file of ``name`` under ``benchmark/<kind>/``; refuses a name it
    cannot find."""
    path = os.path.join(HERE, kind, name + suffix)
    if not os.path.isfile(path):
        raise SystemExit(f'benchmark: no {kind[:-1]} {name!r} '
                         f'(looked for {os.path.relpath(path, ROOT)})')
    return path


def load_json(kind: str, name: str) -> dict:
    with open(_named(kind, name, '.json')) as fh:
        return json.load(fh)


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = _named(kind, name, '.py')
    spec = importlib.util.spec_from_file_location(
        f'benchmark_{kind}_{name}'.replace('.', '_').replace('-', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(workload: str, bench_path: str | None = None):
    """(cell, configuration, mix, end-to-end names, per-layer names) of a
    workload of BENCHMARK.json."""
    bench_path = bench_path or os.path.join(ROOT, 'BENCHMARK.json')
    with open(bench_path) as fh:
        bench = json.load(fh)
    cells = {w['name']: w for w in bench['workloads']}
    if workload not in cells:
        raise SystemExit(f'benchmark: no workload {workload!r} in '
                         f'BENCHMARK.json')
    cell = cells[workload]

    def mine(m):
        return 'workloads' not in m or workload in m['workloads']

    e2e = [m['name'] for m in bench['end_to_end'] if mine(m)]
    layer = [m['name'] for m in bench['per_layer'] if mine(m)]
    for name in layer:
        _named('metrics', name, '.py')
    return (cell, load_json('configs', cell['config']),
            load_json('mixes', cell['traffic']), e2e, layer)


def reference_fasta(config: dict) -> str:
    """The configuration's reference FASTA, written once per checkout."""
    from benchmark import gen
    folder = os.path.join(CACHE, config['name'])
    path = os.path.join(folder, 'ref.fa')
    if not os.path.exists(path):
        os.makedirs(folder, exist_ok=True)
        gen.write_reference(config, path)
    return path


def make_samples(config, mix, ref_path, seed, root):
    """The warm-up sample and ``mix['samples']`` window samples of
    ``seed``, each written as a FASTQ folder under ``root``.  The warm-up
    sample is one more of the window's size, so that it runs every path
    the window runs (clustering's path depends on the sample's size)."""
    from benchmark import gen
    ref = gen.Reference(config, ref_path)
    sizes = [mix['reads_per_sample']] * (1 + int(mix['samples']))

    def one(k):
        s = gen.make_sample(config, mix, ref, _sample_seed(seed, k),
                            sizes[k])
        folder = os.path.join(root, f'in_{k}')
        if mapped(config):
            s['maps'] = gen.write_mappings(config, s, folder,
                                           _sample_seed(seed, k))
            s['n_input'] = len(set(s['maps']['read'].tolist()))
        else:
            gen.write_sample(s, folder, int(mix['reads_per_file']),
                             workers=2)
            s['n_input'] = len(s['names'])
        return s, folder

    with ThreadPoolExecutor(4) as ex:
        made = list(ex.map(one, range(len(sizes))))
    return made[0], made[1:]


def mapped(config: dict) -> bool:
    """Whether the configuration clusters an earlier run's mappings
    (``"input": "mappings"``: ``--skip-alignment``) rather than reading
    FASTQ."""
    return config.get('input', 'fastq') == 'mappings'


def _sample_seed(seed: int, k: int) -> int:
    return int(seed) * 64 + k


class Program:
    """``fslr_tpu_torch`` driven as the CLI drives it."""

    def __init__(self, config: dict, ref_path: str, device):
        from fslr_tpu_torch import cli, instrument, kernels
        from fslr_tpu_torch.pipeline import run_pipeline
        self.cli, self.instrument, self.kernels = cli, instrument, kernels
        self.run_pipeline = run_pipeline
        self.args = list(config['cli'])
        self.ref_path = ref_path
        self.device = device
        self.mapped = mapped(config)

    def run(self, folder: str, out: str, name: str = 'S', alter=None):
        where = ['--basecalled', folder]
        if self.mapped:
            # the earlier run's outputs in a folder of this run's own
            where = []
            os.makedirs(out, exist_ok=True)
            for f in os.listdir(folder):
                os.link(os.path.join(folder, f), os.path.join(out, f))
        args = self.cli._parser().parse_args(
            ['--name', name, '--out', out, '--ref', self.ref_path, *where,
             '--device', str(self.device), *self.args])
        config = self.cli.config_from_args(args)
        if alter is not None:
            config = alter(config)
        mesh = self.cli.mesh_from_args(args, self.device)
        with contextlib.redirect_stdout(sys.stderr):
            self.run_pipeline(config, self.device, mesh=mesh)
        return os.path.join(out, name)


def _sync(device):
    import torch
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def window(program: Program, samples, seconds: float, root: str,
           trace: bool, alter=None):
    """Run samples back to back until ``seconds`` have passed; returns
    the spans, the profiler (with ``trace``) and the number that
    failed."""
    import torch
    device = program.device
    program.instrument.reset_cells()
    program.kernels.reset_launches()
    _sync(device)
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == 'cuda':
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    spans, failed, error = [], 0, None
    t0 = time.perf_counter()
    with torch.profiler.record_function(WINDOW):
        k = 0
        while time.perf_counter() - t0 < seconds:
            s, folder = samples[k % len(samples)]
            out = os.path.join(root, f'out_{k}')
            a = time.perf_counter()
            try:
                base = program.run(folder, out, alter=alter)
                _sync(device)
            except Exception as e:          # a sample that fails
                failed += 1
                error = f'{type(e).__name__}: {e}'
                print(f'benchmark: sample {k} failed: {error}',
                      file=sys.stderr)
                break
            spans.append(SimpleNamespace(index=k, sample=s, base=base,
                                         start=a - t0,
                                         end=time.perf_counter() - t0))
            k += 1
    if prof is not None:
        _sync(device)
        prof.stop()
    return spans, prof, failed, error


def records(program, spans, prof, stage_names, peak):
    """What the per-layer metrics read."""
    from benchmark import trace as tr
    timings = []
    for sp in spans:
        with open(f'{sp.base}.timings.json') as fh:
            timings.append(json.load(fh))
    lengths = np.concatenate([np.diff(sp.sample['offs']) for sp in spans]) \
        if spans else np.zeros(0, np.int64)
    red = tr.reduce(prof, stage_names, WINDOW) if prof is not None else None
    return SimpleNamespace(
        reads=int(sum(sp.sample['n_input'] for sp in spans)),
        read_lengths=lengths, timings=timings,
        cells=program.instrument.cell_counts(),
        launches=program.kernels.launch_counts(), trace=red,
        peak_bytes=peak, device=device_info(program.device),
        work=lambda kernel: load_module('work', kernel)
        .work(SimpleNamespace(read_lengths=lengths)))


def device_info(device) -> dict:
    import torch
    info = {'platform': 'gpu' if device.type == 'cuda' else device.type,
            'kind': (torch.cuda.get_device_name(device)
                     if device.type == 'cuda' else 'cpu'),
            'count': 1}
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=20)
        info['power_limit'] = out.stdout.strip().splitlines()[0]
    except Exception:
        info['power_limit'] = 'unknown'
    return info


def judge(config, mix, spans, seed, ref_path):
    """The comparison that decides ``correct``: the faults found, summed
    over the window's samples, what each looked at, and its seconds."""
    t = time.perf_counter()
    runs = [(sp.index, sp.sample, sp.base) for sp in spans]
    jd = judge_module(config)
    if mapped(config):
        found, where = jd.judge_window(config, runs)
    else:
        found, where = jd.judge_window(
            config, ref_path, runs, seed, int(mix['judge_reads']),
            int(mix['judge_dp']))
    return found, where, time.perf_counter() - t


def judge_module(config: dict):
    """``judge_clusters`` where the configuration clusters mappings, else
    ``judge``."""
    from benchmark import judge, judge_clusters
    return judge_clusters if mapped(config) else judge


def run_cell(config, mix, e2e, layer, seed, seconds, trace, device,
             alter=None, t0=None, warm=True):
    """One run of a cell on ``device``; returns the result's dict (the
    ``compared`` entry last) and the lines for standard error.
    ``alter`` (a function of the program's PipelineConfig) changes what
    the window runs: the control of ``control.py`` and the tests.
    ``warm=False`` leaves the warm-up out (``control.py``'s readings of
    the comparison, which time nothing)."""
    import torch

    LIMITS = judge_module(config).LIMITS
    t0 = _T0 if t0 is None else t0
    root = tempfile.mkdtemp(prefix='fslr_bench_')
    try:
        parts = {'start': time.perf_counter() - t0}
        ref_path = reference_fasta(config)
        parts['fasta'] = time.perf_counter() - t0
        warm_sample, samples = make_samples(config, mix, ref_path, seed,
                                            root)
        parts['samples'] = time.perf_counter() - t0
        program = Program(config, ref_path, device)
        parts['program_import'] = time.perf_counter() - t0
        if warm:
            program.run(warm_sample[1], os.path.join(root, 'out_warm'))
            _sync(device)
        parts['warmup'] = time.perf_counter() - t0
        shutil.rmtree(os.path.join(root, 'out_warm'), ignore_errors=True)
        setup_s = time.perf_counter() - t0
        spans, prof, failed, error = window(program, samples, seconds,
                                            root, trace, alter)
        elapsed = spans[-1].end if spans else float('nan')
        reads = sum(sp.sample['n_input'] for sp in spans)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == 'cuda' else 0)
        stage_names = set()
        for sp in spans:
            with open(f'{sp.base}.timings.json') as fh:
                stage_names |= set(json.load(fh)['timings_s'])
        rec = records(program, spans, prof, stage_names, peak)
        del prof
        gc.collect()
        if device.type == 'cuda':
            torch.cuda.empty_cache()
        metrics = {}
        if not trace:
            values = {'reads_per_s': (reads / elapsed, 'reads/s'),
                      'setup_s': (setup_s, 's')}
            metrics = {k: {'value': values[k][0], 'unit': values[k][1]}
                       for k in e2e}
        else:
            for name in layer:
                m = load_module('metrics', name)
                v = m.read(rec)
                if v is not None:
                    metrics[name] = {'value': v, 'unit': m.UNIT}
        found, where, ref_s = judge(config, mix, spans, seed, ref_path)
        compared = {k: {'value': found[k], 'limit': LIMITS[k]}
                    for k in found}
        ok = (not failed and bool(spans)
              and all(found[k] <= LIMITS[k] for k in found))
        dev = {k: v for k, v in rec.device.items() if k != 'power_limit'}
        dev['memory_peak_bytes'] = int(peak)
        result = {'correct': ok, 'attempted': len(spans) + failed,
                  'failed': failed, 'metrics': metrics, 'device': dev}
        if trace and rec.trace is not None:
            t = rec.trace
            dev['busy_s'] = t['busy_us'] / 1e6
            dev['window_s'] = t['window_us'] / 1e6
            result['breakdown'] = {
                'device_ops': [[k, v / 1e6] for k, v in sorted(
                    t['by_kernel_us'].items(), key=lambda kv: -kv[1])[:10]],
                'idle_gaps': [[k, v / 1e6] for k, v in sorted(
                    t['idle_by_stage_us'].items(),
                    key=lambda kv: -kv[1])[:10]]}
        result['compared'] = compared
        lines = [f'benchmark: set-up ends (s from the start): '
                 f'{json.dumps(parts)}',
                 f'benchmark: {len(spans)} samples, {reads} reads in '
                 f'{elapsed:.3f} s of window, set-up {setup_s:.3f} s, '
                 f'judged in {ref_s:.3f} s, power limit '
                 f'{rec.device["power_limit"]}',
                 f'benchmark: clustering paths '
                 f'{[t.get("query_graph", {}).get("path") for t in rec.timings]}',
                 f'benchmark: where {json.dumps(where)[:3000]}']
        if error:
            lines.append(f'benchmark: failed: {error}')
        lines += [f'compared {k}: {v["value"]} (limit {v["limit"]})'
                  for k, v in compared.items()]
        return result, lines, where
    finally:
        shutil.rmtree(root, ignore_errors=True)


def forbidden_modules() -> list[str]:
    return sorted({m.split('.')[0] for m in list(sys.modules)
                   if m.split('.')[0] in FORBIDDEN})


def _env():
    """Build and kernel caches inside the checkout, at fixed paths."""
    os.environ.setdefault('TORCH_EXTENSIONS_DIR',
                          os.path.join(CACHE, 'torch_extensions'))
    os.environ.setdefault('TRITON_CACHE_DIR', os.path.join(CACHE, 'triton'))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog='python3 -m benchmark.run')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', required=True, type=int)
    ap.add_argument('--seconds', required=True, type=float)
    ap.add_argument('--trace', required=True, type=int, choices=(0, 1))
    args = ap.parse_args(argv)
    cell, config, mix, e2e, layer = load_cell(args.workload)
    _env()
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell['chips']):
        print(f'benchmark: {args.workload} needs {cell["chips"]} CUDA '
              f'card(s); torch sees '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 2
    import fslr_tpu_torch  # noqa: F401  (fails where the program is absent)
    result, lines, _where = run_cell(config, mix, e2e, layer, args.seed,
                                     args.seconds, bool(args.trace),
                                     torch.device('cuda', 0))
    bad = forbidden_modules()
    if bad:
        print(f'benchmark: the run loaded {bad}', file=sys.stderr)
        return 3
    sys.stdout.flush()
    print('\n'.join(lines), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())
