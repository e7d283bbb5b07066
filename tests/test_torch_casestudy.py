"""The paper's case study in the port, on the CPU, against the reference.

Each of the 27 benchmarks runs once in each package under a recording
``OpProfiler`` (test-only subclasses that log every bracketed call).  The
two packages draw their random inputs from different generators, so the
calls are compared by what is deterministic, and each call's numbers by
replaying it:

* the categories, ``calls``, ``samples_in`` and ``samples_out``: equal,
  call by call (they also equal the table ``chip_smoke.py`` holds the
  card's run to);
* every bracketed call is replayed: the port's recorded function on the
  reference's recorded inputs (as numpy) comes within
  |d| <= 1e-4 * max|ref| of the reference's recorded output, in the same
  dtype.  Both compute fp32 FFTs and convolutions of up to 1500^2 (or a
  100x100 kernel) elements in other summation orders, which stays orders
  of magnitude inside that bound;
* the ``optics_sim`` primitives on a 128^2 field: the same bound;
* Fig. 8: the cost-model breakdown to rtol 1e-12 (the same float64
  arithmetic), the functional sim's intensity error within 10 % of the
  reference's (other random frames); Fig. 2 and Fig. 3: equal.
"""

import math

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from benchmarks import amdahl_suite as jsuite
from benchmarks import complexity_fig as jfig3
from benchmarks import conversion_bottleneck as jfig8
from benchmarks import optics_sim as jop
from benchmarks import pareto as jfig2
from repro.core import profiler as jprof
from repro_torch.casestudy import amdahl_suite as tsuite
from repro_torch.casestudy import complexity_fig as tfig3
from repro_torch.casestudy import conversion_bottleneck as tfig8
from repro_torch.casestudy import optics_sim as top
from repro_torch.casestudy import pareto as tfig2
from repro_torch.casestudy import run as trun
from repro_torch.core import profiler as tprof

CPU = torch.device("cpu")
REL = 1e-4
_WL = 633e-9


def _recording(base):
    class Recording(base):
        """Logs (category, fn, args, kwargs, out, n_in, n_out) per call."""

        def __init__(self):
            super().__init__()
            self.log = []

        def run(self, category, fn, *args, **kwargs):
            n_in, n_out = (self.samples_in[category],
                           self.samples_out[category])
            out = super().run(category, fn, *args, **kwargs)
            self.log.append((category, fn, args, kwargs, out,
                             self.samples_in[category] - n_in,
                             self.samples_out[category] - n_out))
            return out
    return Recording


JRecording = _recording(jprof.OpProfiler)
TRecording = _recording(tprof.OpProfiler)


def _to_torch(x):
    if isinstance(x, jax.Array):
        return torch.from_numpy(np.array(x))
    return x


def _close(got: np.ndarray, want: np.ndarray) -> tuple[float, float]:
    """(max |got - want|, the bound REL * max |want|)."""
    return (float(np.max(np.abs(got - want))),
            REL * float(np.max(np.abs(want))))


@pytest.mark.parametrize("name", [n for n, _ in jsuite.BENCHMARKS])
def test_benchmark_matches_reference(name):
    jfn = dict(jsuite.BENCHMARKS)[name]
    tfn = dict(tsuite.BENCHMARKS)[name]
    jrec, trec = JRecording(), TRecording()
    jfn(jrec)
    tfn(trec, CPU)

    shape = [(c, ni, no) for c, *_, ni, no in jrec.log]
    assert [(c, ni, no) for c, *_, ni, no in trec.log] == shape
    assert {c: (jrec.calls[c], jrec.samples_in[c], jrec.samples_out[c])
            for c in jrec.calls} == chip_smoke.CASESTUDY_COUNTS[name]

    for i, (jcall, tcall) in enumerate(zip(jrec.log, trec.log)):
        _, _, jargs, jkwargs, jout, *_ = jcall
        _, tfn_i, *_ = tcall
        got = tfn_i(*map(_to_torch, jargs),
                    **{k: _to_torch(v) for k, v in jkwargs.items()})
        assert isinstance(got, torch.Tensor)
        want = np.asarray(jout)
        assert got.numpy().dtype == want.dtype, (i, got.dtype)
        assert tuple(got.shape) == want.shape, i
        err, bound = _close(got.numpy(), want)
        assert np.isfinite(err) and err <= bound, (i, err, bound)


# --- optics_sim primitives -----------------------------------------------------

_ELEMENTS = {
    "circ_aperture": lambda m, f: m.circ_aperture(f, 1.0e-3, 2e-4, -1e-4),
    "circ_screen": lambda m, f: m.circ_screen(f, 0.8e-3),
    "rect_slits": lambda m, f: m.rect_slits(
        f, 0.2e-3, 1e-3, [(-0.5e-3, 0), (0.5e-3, 0.2e-3)]),
    "gauss": lambda m, f: m.gauss(f, 1.5e-3),
    "lens": lambda m, f: m.lens(f, 0.5),
    "axicon": lambda m, f: m.axicon(f, 0.01),
    "spiral_phase_plate": lambda m, f: m.spiral_phase_plate(f, 2),
    "zone_plate": lambda m, f: m.zone_plate(f, 0.5),
    "tilt": lambda m, f: m.tilt(f, 2e-4, -1e-4),
    "lenslet_array": lambda m, f: m.lenslet_array(f, 1e-3, 0.05),
    "hermite_gauss": lambda m, f: m.hermite_gauss(f, 2, 1, 1.5e-3),
    "forvard": lambda m, f: m.forvard(m.gauss(f, 1e-3), 0.3),
    "forvard_profiled": lambda m, f: m.forvard(
        m.circ_aperture(f, 1e-3), 0.5, (tprof.OpProfiler() if m is top
                                        else jprof.OpProfiler())),
}


@pytest.mark.parametrize("element", list(_ELEMENTS))
def test_optics_element_matches_reference(element):
    jf = _ELEMENTS[element](jop, jop.gauss(jop.begin(5e-3, _WL, 128), 2e-3))
    tf = _ELEMENTS[element](top, top.gauss(top.begin(5e-3, _WL, 128, CPU),
                                           2e-3))
    assert (tf.size_m, tf.wavelength) == (jf.size_m, jf.wavelength)
    assert tf.u.dtype == torch.complex64 and tf.u.device == CPU
    err, bound = _close(tf.u.numpy(), np.asarray(jf.u))
    assert err <= bound, (err, bound)
    err, bound = _close(top.intensity(tf).numpy(),
                        np.asarray(jop.intensity(jf)))
    assert err <= bound, (err, bound)


def test_far_field_and_grid_match_reference():
    jf = jop.circ_aperture(jop.begin(4e-3, _WL, 128), 0.8e-3)
    tf = top.circ_aperture(top.begin(4e-3, _WL, 128, CPU), 0.8e-3)
    for got, want in zip(tf.grid(), jf.grid()):
        assert np.array_equal(got.numpy(), np.asarray(want))
    prof = tprof.OpProfiler()
    got = top.far_field(tf, prof)
    err, bound = _close(got.numpy(), np.asarray(jop.far_field(jf)))
    assert err <= bound, (err, bound)
    assert dict(prof.calls) == {"fft": 1}
    assert torch.equal(top.far_field(tf), got)


# --- run_one and the CLI ----------------------------------------------------------------

def test_run_one_reports_a_table1_row():
    rec = []

    class Counted(tprof.OpProfiler):
        def __init__(self):
            super().__init__()
            rec.append(self)

    row = tsuite.run_one("youngs_experiment", tsuite.bench_youngs_experiment,
                         repeats=2, device="cpu", profiler=Counted)
    assert row.name == "youngs_experiment"
    assert 0.0 < row.fraction <= 1.0 and row.end_to_end_speedup >= 1.0
    warm, timed = rec
    assert warm.calls == {"fft": 1} and timed.calls == {"fft": 2}
    assert row.total_time_s == timed.total_s


def test_same_pads_match_xla():
    # audio_resampling: 48000 samples, 129 taps, stride 3 -> 16000 outputs
    assert tsuite._same_pads(48_000, 129, 3) == (63, 63)
    for n, k, s in [(10, 4, 3), (11, 2, 2), (7, 5, 1), (5, 9, 2)]:
        lo, hi = tsuite._same_pads(n, k, s)
        assert (n + lo + hi - k) // s + 1 == math.ceil(n / s)
        assert 0 <= hi - lo <= 1


def test_run_cli_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert trun.main([]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA card" in out.err


# --- the figures ------------------------------------------------------------------

def test_fig8_matches_reference():
    want, got = jfig8.run(), tfig8.run("cpu")
    for key in ("hardware_total_s", "hardware_movement_pct",
                "paper_hardware_vs_software", "paper_movement_pct"):
        assert got[key] == pytest.approx(want[key], rel=1e-12)
    for key, v in want["breakdown"].items():
        assert got["breakdown"][key] == pytest.approx(v, rel=1e-12)
    assert got["sim_intensity_rel_err"] == pytest.approx(
        want["sim_intensity_rel_err"], rel=0.10)
    assert got["software_fft_s"] > 0.0
    assert got["hardware_vs_software"] == pytest.approx(
        got["hardware_total_s"] / got["software_fft_s"], rel=1e-12)


def test_fig2_matches_reference():
    assert tfig2.run() == jfig2.run()


def test_fig3_matches_reference():
    assert tfig3.run() == jfig3.run()
