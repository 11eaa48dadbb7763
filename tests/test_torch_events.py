"""Port parity: the event simulator and the REPROTRC staleness-trace files
(``async_engine/events.py``).

Contracts, all exact:
* ``simulate_staleness_trace`` gives identical taus and workers for the same
  config and seed (numpy's generator in both packages), in the
  deep-learning regime and the parameter-server regime;
* a trace written by either package loads in the other with equal arrays,
  and equal records give byte-identical files (v2 and, through
  ``TraceWriter(resume=True)`` over a v1 file, the re-stamped v2);
* both packages refuse the same malformed files: a torn tail unless
  ``allow_partial``, a leftover ``.part`` unless ``allow_partial``.
"""

import os
import struct

import numpy as np
import pytest

from repro.async_engine import events as JE
from repro_torch.async_engine import events as TE

REGIMES = {
    "dl": dict(m=8, compute_mean=1.0, apply_mean=0.02),
    "ps": dict(m=8, compute_mean=0.01, apply_mean=1.0, jitter=0.05),
}


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_simulated_traces_identical(regime, seed):
    cfg_j, cfg_t = JE.EventSimConfig(**REGIMES[regime]), TE.EventSimConfig(**REGIMES[regime])
    tj, wj = JE.simulate_staleness_trace(cfg_j, 3000, seed=seed, return_workers=True)
    tt, wt = TE.simulate_staleness_trace(cfg_t, 3000, seed=seed, return_workers=True)
    assert tt.dtype == tj.dtype and wt.dtype == wj.dtype
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(wt, wj)
    np.testing.assert_array_equal(TE.simulate_staleness_trace(cfg_t, 3000, seed=seed), tj)


def _records(n=50, seed=3):
    r = np.random.default_rng(seed)
    return [(int(r.integers(0, 40)), int(r.integers(0, 8)), float(r.random() * 1e9),
             float(r.random() * 1e9 + 1.0)) for _ in range(n)]


def _write(mod, path, recs):
    w = mod.TraceWriter(path)
    for tau, worker, tp, ts in recs:
        w.append(tau, worker, t_pull=tp, t_push=ts)
    return w.finalize()


@pytest.mark.parametrize("writer,reader", [(JE, TE), (TE, JE)], ids=["ref->port", "port->ref"])
def test_trace_files_cross_packages(tmp_path, writer, reader):
    recs = _records()
    path = _write(writer, str(tmp_path / "live.trace"), recs)
    assert not os.path.exists(path + ".part")
    taus, workers, t_pull, t_push = reader.load_trace(path, return_workers=True, return_times=True)
    np.testing.assert_array_equal(taus, [r[0] for r in recs])
    np.testing.assert_array_equal(workers, [r[1] for r in recs])
    np.testing.assert_array_equal(t_pull, [r[2] for r in recs])
    np.testing.assert_array_equal(t_push, [r[3] for r in recs])
    assert taus.dtype == np.int64 and workers.dtype == np.int32
    np.testing.assert_array_equal(reader.load_trace(path), JE.load_trace(path))


def test_equal_records_give_byte_identical_files(tmp_path):
    recs = _records(80, seed=5)
    a = _write(JE, str(tmp_path / "a.trace"), recs)
    b = _write(TE, str(tmp_path / "b.trace"), recs)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        raw_a, raw_b = fa.read(), fb.read()
    assert raw_a == raw_b
    assert len(raw_b) == TE._TRACE_HEADER.size + 80 * TE._TRACE_RECORD.size
    assert TE._TRACE_HEADER.unpack_from(raw_b) == (b"REPROTRC", 2, 24)


def _v1_file(path, pairs):
    with open(path, "wb") as f:
        f.write(struct.pack("<8sII", b"REPROTRC", 1, 8))
        for tau, worker in pairs:
            f.write(struct.pack("<ii", tau, worker))


def test_v1_trace_loads_in_both(tmp_path):
    pairs = [(3, 0), (0, 1), (7, 2), (2, 1)]
    path = str(tmp_path / "old.trace")
    _v1_file(path, pairs)
    for mod in (JE, TE):
        taus, workers, t_pull, t_push = mod.load_trace(path, return_workers=True,
                                                       return_times=True)
        np.testing.assert_array_equal(taus, [p[0] for p in pairs])
        np.testing.assert_array_equal(workers, [p[1] for p in pairs])
        assert t_pull is None and t_push is None


def test_torn_tail_refused_then_salvaged(tmp_path):
    recs = _records(10)
    path = _write(TE, str(tmp_path / "torn.trace"), recs)
    with open(path, "ab") as f:
        f.write(b"\x01\x02\x03")  # a torn record
    for mod in (JE, TE):
        with pytest.raises(mod.TraceError, match="torn"):
            mod.load_trace(path)
        taus = mod.load_trace(path, allow_partial=True)
        np.testing.assert_array_equal(taus, [r[0] for r in recs])


@pytest.mark.parametrize("writer", [JE, TE], ids=["ref-writer", "port-writer"])
def test_part_file_refused_unless_partial(tmp_path, writer):
    path = str(tmp_path / "crashed.trace")
    w = writer.TraceWriter(path)
    for tau, worker, tp, ts in _records(6):
        w.append(tau, worker, t_pull=tp, t_push=ts)
    w.abort()
    assert os.path.exists(path + ".part") and not os.path.exists(path)
    for mod in (JE, TE):
        with pytest.raises(mod.TraceError, match="never finalized"):
            mod.load_trace(path)
        assert len(mod.load_trace(path, allow_partial=True)) == 6
        with pytest.raises(mod.TraceError, match="no trace file"):
            mod.load_trace(str(tmp_path / "absent.trace"))


def test_bad_magic_and_version_refused(tmp_path):
    bad = str(tmp_path / "bad.trace")
    with open(bad, "wb") as f:
        f.write(struct.pack("<8sII", b"NOTATRCE", 2, 24))
    future = str(tmp_path / "future.trace")
    with open(future, "wb") as f:
        f.write(struct.pack("<8sII", b"REPROTRC", 9, 24))
    for mod in (JE, TE):
        with pytest.raises(mod.TraceError, match="bad magic"):
            mod.load_trace(bad)
        with pytest.raises(mod.TraceError, match="unsupported"):
            mod.load_trace(future)


@pytest.mark.parametrize("writer", [JE, TE], ids=["ref-writer", "port-writer"])
def test_resume_extends_capture_identically(tmp_path, writer):
    """``TraceWriter(resume=True)`` seeds the new capture with the old one's
    records — a finalized v2 file, a leftover .part, or a v1 file re-stamped
    as 0.0 — and both packages produce the same bytes."""
    first, more = _records(7, seed=1), _records(5, seed=2)
    outs = {}
    for mod in (JE, TE):
        d = tmp_path / f"{mod.__name__.split('.')[0]}"
        d.mkdir()
        fin = _write(writer, str(d / "fin.trace"), first)
        part = str(d / "part.trace")
        w = writer.TraceWriter(part)
        for tau, worker, tp, ts in first:
            w.append(tau, worker, t_pull=tp, t_push=ts)
        w.abort()
        v1 = str(d / "v1.trace")
        _v1_file(v1, [(r[0], r[1]) for r in first])
        for path in (fin, part, v1):
            w = mod.TraceWriter(path, resume=True)
            assert w.count == len(first)
            for tau, worker, tp, ts in more:
                w.append(tau, worker, t_pull=tp, t_push=ts)
            w.finalize()
            with open(path, "rb") as f:
                outs.setdefault(os.path.basename(path), []).append(f.read())
    for name, (raw_j, raw_t) in outs.items():
        assert raw_j == raw_t, name
    taus, _, t_pull, _ = TE.load_trace(str(tmp_path / "repro_torch" / "v1.trace"),
                                       return_workers=True, return_times=True)
    np.testing.assert_array_equal(taus, [r[0] for r in first + more])
    np.testing.assert_array_equal(t_pull[: len(first)], 0.0)
