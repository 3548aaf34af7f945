"""The metric arithmetic: the interval union, the per-layer readers on
hand-made records, and the mask kernel's work."""

from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import run, trace


def test_union_and_overlap():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 41)]
    assert trace.union_us(iv) == 26
    assert trace.merged(iv) == [[0, 15], [20, 30], [40, 41]]
    assert trace.union_us([]) == 0


def test_kernel_names():
    assert trace.kernel_name('void sw_dp<true>(unsigned char const*, '
                             'int)') == 'sw_dp'
    assert trace.kernel_name('mask_kernel(unsigned char const*)') == \
        'mask_kernel'
    assert trace.kernel_name('Memcpy HtoD (Pageable -> Device)') == \
        'Memcpy HtoD'
    # the port's kernels live in an anonymous namespace
    assert trace.kernel_name('(anonymous namespace)::mask_kernel(unsigned '
                             'char const*, float*)') == 'mask_kernel'
    assert trace.kernel_name('void (anonymous namespace)::sw_dp<true>(int'
                             ')') == 'sw_dp'


class _Prof:
    """A stopped profiler's raw events, as trace.events reads them."""

    def __init__(self, evs):
        self.profiler = SimpleNamespace(kineto_results=SimpleNamespace(
            events=lambda: [_Ev(*e) for e in evs]))


class _Ev:
    def __init__(self, name, a, b, dev):
        import torch
        self._n, self._a, self._b = name, a, b
        self._d = (torch.autograd.DeviceType.CUDA if dev
                   else torch.autograd.DeviceType.CPU)

    def name(self):
        return self._n

    def start_ns(self):
        return self._a * 1000

    def duration_ns(self):
        return (self._b - self._a) * 1000

    def device_type(self):
        return self._d


def test_reduce_window_busy_idle_by_stage():
    evs = [(run.WINDOW, 100, 200, False), ('align', 100, 150, False),
           ('align_emit', 140, 150, False), ('bam_write', 150, 200, False),
           ('mask_kernel(x)', 90, 110, True),        # cut at the window
           ('void sw_dp<true>(x)', 120, 130, True),
           ('align', 100, 150, True),                # an annotation
           ('Memcpy HtoD (Pageable -> Device)', 145, 147, True),
           ('void sw_dp<false>(x)', 210, 220, True)]  # after the window
    r = trace.reduce(_Prof(evs), {'align', 'align_emit', 'bam_write'},
                     run.WINDOW)
    assert r['window_us'] == 100
    assert r['busy_us'] == 10 + 10 + 2
    assert r['by_kernel_us'] == {'mask_kernel': 10, 'sw_dp': 10,
                                 'Memcpy HtoD': 2}
    # gaps: 110-120 and 130-140 in align, 140-145 and 147-150 in
    # align_emit (inside align), 150-200 in bam_write
    assert r['idle_by_stage_us'] == {'align': 20, 'align_emit': 8,
                                     'bam_write': 50}


def _rec(**kw):
    base = dict(reads=4000, read_lengths=np.full(4000, 1000),
                timings=[{'timings_s': {'align': 2.0, 'read_labelled': 0.5,
                                        'filter_junk': 1.0,
                                        'load_index': 0.2}},
                         {'timings_s': {'align': 1.0, 'filter_junk': 1.0,
                                        'load_index': 0.2}}],
                cells={'extend': 6e9}, launches={}, peak_bytes=3 * 2**30,
                device={'kind': 'NVIDIA H100 80GB HBM3'},
                trace={'busy_us': 2e6, 'window_us': 8e6,
                       'by_kernel_us': {'mask_kernel': 5e4, 'sw_dp': 2e4,
                                        'order_rows': 1e3, 'Memcpy': 9e9},
                       'idle_by_stage_us': {}},
                work=lambda k: run.load_module('work', k).work(
                    SimpleNamespace(read_lengths=np.full(4000, 1000))))
    base.update(kw)
    return SimpleNamespace(**base)


def _read(name, rec):
    m = run.load_module('metrics', name)
    return m.read(rec), m.UNIT


def test_stage_metrics_ms_per_kread():
    rec = _rec()
    assert _read('align.ms_per_kread', rec) == (pytest.approx(875.0),
                                                'ms/kread')
    assert _read('filter_junk.ms_per_kread', rec)[0] == pytest.approx(500)
    assert _read('index.wait_ms_per_kread', rec)[0] == pytest.approx(100)
    # a stage that no sample ran: nothing to read
    assert _read('clustering.ms_per_kread',
                 _rec(timings=[{'timings_s': {}}]))[0] is None
    assert _read('align.extend_gcells_per_s', rec)[0] == pytest.approx(2.0)
    assert _read('device.idle_share', rec)[0] == pytest.approx(75.0)
    assert _read('device.peak_gib', rec)[0] == pytest.approx(3.0)
    assert _read('kernels.device_ms_per_kread', rec)[0] == \
        pytest.approx(71.0 / 4)


def test_mask_work_and_roofline():
    rec = _rec()
    w = rec.work('mask_kernel')
    assert w == {'ops': 12 * 100 * 4_000_000, 'bytes': 5 * 4_000_000}
    least = max(w['ops'] / 67e12, w['bytes'] / 3.35e12)
    share, unit = _read('mask_kernel_roofline', rec)
    assert unit == '%'
    assert share == pytest.approx(100 * least / 0.05)
    # no entry in the table of peaks, or no mask event: nothing to read
    assert _read('mask_kernel_roofline',
                 _rec(device={'kind': 'cpu'}))[0] is None
    assert _read('mask_kernel_roofline',
                 _rec(trace=None))[0] is None

