"""Bias-engine tests — ported from reference tests/edm_test.cpp:846-905 plus
capping/deferral scenarios pinned against the compiled reference binary.

Oracle provenance: /root/reference built serially at -O2 and driven with the
exact scenarios below; numbers quoted to 12 digits.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from edm_tpu import bias as B
from edm_tpu.api import EDMBias
from edm_tpu.utils.config import parse_edm_file, parse_edm_text

import pathlib

SANITY = str(pathlib.Path(__file__).parent / "fixtures" / "sanity.edm")


def test_edm_bias_reader(fixture_dir):
    # edm_test.cpp:846-852 — read_test.edm parse (reader only; the target
    # grid file it names is generated by another test in the reference suite)
    text = (fixture_dir / "read_test.edm").read_text()
    # drop the target to parse standalone
    text = "\n".join(l for l in text.splitlines() if not l.startswith("target_filename"))
    cfg = parse_edm_text(text)
    assert cfg.dim == 2
    assert cfg.b_tempering is False
    assert abs(cfg.bias_sigma[0] - 2) < 1e-12
    assert abs(cfg.bias_dx[1] - 1.0) < 1e-12


def test_config_quirks():
    cfg = parse_edm_text(
        "tempering 0\nhill_prefactor 0.5\ndimension 1\nbox_low 0\nbox_high 10\n"
        "bias_spacing 0.1\nbias_sigma 0.2\n"
    )
    assert cfg.bias_per_step == 0.5  # defaults to prefactor (edm_bias.cpp:1022)
    assert cfg.hill_density == -1.0
    # first occurrence wins for duplicate keys (map insert semantics)
    cfg2 = parse_edm_text(
        "tempering 0\nhill_prefactor 0.5\nhill_prefactor 0.9\ndimension 1\n"
        "box_low 0\nbox_high 10\nbias_spacing 0.1\nbias_sigma 0.2\n"
    )
    assert cfg2.hill_prefactor == 0.5
    # zero-valued optional double falls back to default (edm_bias.cpp:937-940)
    cfg3 = parse_edm_text(
        "tempering 0\nhill_prefactor 0.5\nbias_per_step 0.0\ndimension 1\n"
        "box_low 0\nbox_high 10\nbias_spacing 0.1\nbias_sigma 0.2\n"
    )
    assert cfg3.bias_per_step == 0.5


def _sanity_bias(tmp_path):
    b = EDMBias(SANITY, dtype=jnp.float64, log_hills=False)
    b.setup(1, 1)
    b.subdivide([0], [10], [0], [10], [True], [0])
    return b


def test_edm_sanity(tmp_path):
    # edm_test.cpp:873-905 + oracle pins:
    #   peak=0.997355701004 cum=0.249980997885 der(4.99)=+0.992430688634
    b = _sanity_bias(tmp_path)
    b.add_hills(np.array([[5.0]]), np.array([1.0]))

    peak = b.bias_value([5.0])
    assert abs(peak - 0.997355701004) < 1e-9
    assert abs(peak - b.cfg.hill_prefactor / np.sqrt(2 * np.pi) / b.cfg.bias_sigma[0]) ** 2 < 1e-5
    assert abs(b.cum_bias - 0.249980997885) < 1e-9
    assert (b.cum_bias - b.cfg.hill_prefactor) ** 2 < 0.001

    e, der = b.get_force([4.99])
    assert -der[0] < 0
    assert abs(der[0] - 0.992430688634) < 1e-8
    e, der = b.get_force([5.01])
    assert -der[0] > 0


# NOTE bias_spacing 0.0097: with spacing 0.01 the Gaussian support radius
# sqrt(8)*sigma*sqrt(2)/dx is EXACTLY 80 grid points and per-center rounding
# luck decides whether the reference includes the edge points (its own
# per-hill integrals vary by ~1.3e-5 across identical hills at x=2,3,4,5).
# A non-integer support radius removes the knife edge so 1e-9 parity with
# the reference binary is meaningful.
CAP_EDM = (
    "tempering 0\nhill_prefactor 1.0\nbias_per_step 0.6\ndimension 1\n"
    "box_low 0\nbox_high 10\nbias_spacing 0.0097\nbias_sigma 0.2\n"
)


def _cap_bias(tmp_path):
    p = tmp_path / "cap.edm"
    p.write_text(CAP_EDM)
    b = EDMBias(str(p), dtype=jnp.float64, log_hills=False)
    b.setup(1, 1)
    b.subdivide([0], [10], [0], [10], [True], [0])
    return b


def test_bias_per_step_capping(tmp_path):
    """5 hills x h=0.2 against cap 0.6: 3 full deposits, a partially-undone
    straddler, one deferred.  Oracle (reference binary, spacing 0.0097):
      cum=0.600013947890, v(5)=0.000103349086, v(6)=0
    """
    b = _cap_bias(tmp_path)
    b.add_hills(np.array([[2.0], [3.0], [4.0], [5.0], [6.0]]), np.ones(5))

    assert abs(b.cum_bias - 0.600013947890) < 1e-9
    for x, oracle in ((2.0, 0.398942273344), (3.0, 0.398942268241), (4.0, 0.398942264516)):
        assert abs(b.bias_value([x]) - oracle) < 1e-9
    assert abs(b.bias_value([5.0]) - 0.000103349086) < 1e-9
    assert b.bias_value([6.0]) == 0.0
    # both the straddler remainder and the fifth hill are deferred
    assert int(b.state.buf_right) - int(b.state.buf_left) == 2


def test_deferred_drain(tmp_path):
    """Draining the overflow buffer on later rounds.

    DELIBERATE FIX vs reference (SURVEY.md Q3): the reference's overflow
    buffer pre-increments its right cursor, so the *last* hill deferred in a
    round is silently dropped and a spurious zero-height hill at the origin
    is replayed instead (verified on the reference binary: the x=6 hill
    deferred above never reappears — v(6)=0 forever and cum_bias freezes at
    0.7999518).  Deferral exists precisely to avoid sample bias, so we use
    correct FIFO semantics: every deferred hill is eventually deposited.
    """
    b = _cap_bias(tmp_path)
    b.add_hills(np.array([[2.0], [3.0], [4.0], [5.0], [6.0]]), np.ones(5))
    cum1 = b.cum_bias

    # drain round (no new hills accepted while leftovers exist)
    b.pre_add_hill(1)
    b.post_add_hill()
    full = 0.398942263164  # oracle: drained straddler remainder tops up x=5
    assert abs(b.bias_value([5.0]) - full) < 1e-9
    assert b.bias_value([6.0]) > 0.39  # reference loses this hill (Q3); we keep it
    assert int(b.state.buf_right) == 0 and int(b.state.buf_left) == 0
    # cum advanced by the two drained deposits (~0.2*s each)
    assert 0.39 < b.cum_bias - cum1 < 0.41

    # further rounds proceed normally
    b.add_hills(np.array([[7.0], [8.0]]), np.ones(2))
    assert abs(b.bias_value([7.0]) - 0.997355670602) < 1e-9


def test_multi_pass_round_chains_cap_and_buffer(tmp_path):
    """add_hills_round(n_passes=K) splits the hill batch into K sequential
    sub-batches (the static-shape analog of the reference's mid-round
    flush-and-continue, edm_bias.cpp:459-462).  With grid-independent
    heights the result must match the single-pass round: same cum, same
    grid, same deferred-FIFO content/order, chained cap state — here the
    cap straddler falls INSIDE pass 1 and the deferral spills across the
    pass boundary.  (The live-grid well-tempering semantics of multi-pass
    rounds are pinned against the reference binary in
    test_oracle_sweep.py.)"""
    hills = np.array([[2.0], [3.0], [4.0], [5.0], [6.0], [7.0], [7.5], [8.0]])
    runs = {}
    for passes in (1, 2, 4, "live"):
        p = tmp_path / f"cap_{passes}.edm"
        p.write_text(CAP_EDM)
        b = EDMBias(str(p), dtype=jnp.float64, log_hills=False,
                    hill_passes=passes)
        b.setup(1, 1)
        b.subdivide([0], [10], [0], [10], [True], [0])
        b.add_hills(hills, np.ones(8))
        # drain round, then fresh hills: exercises the FIFO the passes built
        b.pre_add_hill(1)
        b.post_add_hill()
        b.add_hills(np.array([[1.0], [9.0]]), np.ones(2))
        runs[passes] = b
    ref = runs[1]
    for passes in (2, 4, "live"):
        got = runs[passes]
        assert abs(got.cum_bias - ref.cum_bias) < 1e-12, passes
        np.testing.assert_allclose(
            np.asarray(got.state.bias.grid.values),
            np.asarray(ref.state.bias.grid.values), atol=1e-12,
        )
        nb = int(ref.state.buf_right) - int(ref.state.buf_left)
        assert int(got.state.buf_right) - int(got.state.buf_left) == nb
        np.testing.assert_allclose(
            np.asarray(got.state.buf_h)[:nb],
            np.asarray(ref.state.buf_h)[:nb], atol=1e-12,
        )
        np.testing.assert_allclose(
            np.asarray(got.state.buf_pos)[:nb],
            np.asarray(ref.state.buf_pos)[:nb], atol=1e-12,
        )


def test_skip_round_while_leftovers(tmp_path):
    """b_skip_hill_add_: when the drain leaves leftovers, the whole round of
    new hills is skipped (edm_bias.cpp:436-439) — skipping individual hills
    would bias the sampling."""
    p = tmp_path / "cap2.edm"
    p.write_text(
        "tempering 0\nhill_prefactor 1.0\nbias_per_step 0.3\ndimension 1\n"
        "box_low 0\nbox_high 10\nbias_spacing 0.01\nbias_sigma 0.2\n"
    )
    b = EDMBias(str(p), dtype=jnp.float64, log_hills=False)
    b.setup(1, 1)
    b.subdivide([0], [10], [0], [10], [True], [0])
    # round 1: 5 hills, cap 0.3 -> ~1.5 hills deposited, rest deferred
    b.add_hills(np.array([[2.0], [3.0], [4.0], [5.0], [6.0]]), np.ones(5))
    n_buf = int(b.state.buf_right) - int(b.state.buf_left)
    assert n_buf >= 3
    # round 2 with new hills: drain is capped again, leftovers remain -> the
    # new hills must NOT be deposited or deferred
    b.add_hills(np.array([[8.0]]), np.ones(1))
    assert b.bias_value([8.0]) == 0.0
    n_buf2 = int(b.state.buf_right) - int(b.state.buf_left)
    assert n_buf2 < n_buf  # drained some
    # keep draining until empty; only then new hills land
    for _ in range(6):
        b.pre_add_hill(1)
        b.post_add_hill()
    assert int(b.state.buf_right) == 0
    b.add_hills(np.array([[8.0]]), np.ones(1))
    # height is clamped to BIAS_CLAMP*bias_per_step=0.3 (edm_bias.cpp:558):
    # peak = 0.3/(sqrt(2*pi)*0.2)
    assert abs(b.bias_value([8.0]) - 0.3 / np.sqrt(2 * np.pi) / 0.2) < 1e-3


def test_histogram_counts(tmp_path):
    b = _sanity_bias(tmp_path)
    b.add_hills(np.array([[5.0]]), np.array([1.0]))
    hist = np.asarray(b.state.cv_hist.values)
    assert hist.sum() == 1.0
    b.clear_histogram()
    assert np.asarray(b.state.cv_hist.values).sum() == 0.0


def test_stochastic_accept(tmp_path):
    p = tmp_path / "dens.edm"
    p.write_text(
        "tempering 0\nhill_prefactor 1.0\nbias_per_step 100.0\nhill_density 2\n"
        "dimension 1\nbox_low 0\nbox_high 10\nbias_spacing 0.01\nbias_sigma 0.2\n"
    )
    b = EDMBias(str(p), dtype=jnp.float64, log_hills=False)
    b.setup(1, 1)
    b.subdivide([0], [10], [0], [10], [True], [0])
    # accept iff runiform < hill_density / est_hill_count = 2/4 = 0.5
    b.add_hills(np.array([[2.0], [4.0], [6.0], [8.0]]), np.array([0.1, 0.9, 0.4, 0.6]))
    assert b.bias_value([2.0]) > 0.1
    assert b.bias_value([4.0]) < 1e-9
    assert b.bias_value([6.0]) > 0.1
    assert b.bias_value([8.0]) < 1e-9
    # heights normalized by hill_density, not est count (edm_bias.cpp:551-555)
    assert abs(b.bias_value([2.0]) - 1.0 / 2 / np.sqrt(2 * np.pi) / 0.2) < 1e-6


def test_well_tempering(tmp_path):
    # strict `global_tempering < 0` gate (edm_bias.cpp:547)
    base = (
        "tempering 1\nbias_factor 5.0\nglobal_tempering -1\nhill_prefactor 1.0\n"
        "bias_per_step 100.0\ndimension 1\nbox_low 0\nbox_high 10\n"
        "bias_spacing 0.01\nbias_sigma 0.2\n"
    )
    p = tmp_path / "wt.edm"
    p.write_text(base)
    b = EDMBias(str(p), dtype=jnp.float64, log_hills=False)
    b.setup(1, 1)
    b.subdivide([0], [10], [0], [10], [True], [0])
    b.add_hills(np.array([[5.0]]), np.ones(1))
    v1 = b.bias_value([5.0])
    b.add_hills(np.array([[5.0]]), np.ones(1))
    v2 = b.bias_value([5.0])
    # second hill shrunk by exp(-V/( (gamma-1) kT ))
    expected_shrink = np.exp(-v1 / ((5.0 - 1) * 1.0))
    assert abs((v2 - v1) / v1 - expected_shrink) < 0.05


def test_targeting(tmp_path):
    # target reweighting: h *= exp(target(x) - E[target]) (edm_bias.cpp:545-546)
    from edm_tpu import Grid, GridSpec
    from edm_tpu.utils.gridio import write_grid

    spec = GridSpec.create([0], [10], [0.5], [True])
    xs = spec.min[0] + spec.dx[0] * np.arange(spec.nbins[0])
    tvals = 0.1 * xs  # -ln p target
    tgt = Grid(values=jnp.asarray(tvals), derivs=None, spec=spec)
    tf = tmp_path / "target.grid"
    write_grid(tgt, str(tf))

    p = tmp_path / "tgt.edm"
    p.write_text(
        "tempering 0\nhill_prefactor 1.0\nbias_per_step 100.0\ndimension 1\n"
        f"box_low 0\nbox_high 10\nbias_spacing 0.01\nbias_sigma 0.2\ntarget_filename {tf}\n"
    )
    b = EDMBias(str(p), dtype=jnp.float64, log_hills=False)
    b.setup(1, 1)
    b.subdivide([0], [10], [0], [10], [True], [0])
    b.add_hills(np.array([[2.0], [8.0]]), np.ones(2))
    v2, v8 = b.bias_value([2.0]), b.bias_value([8.0])
    # ratio of heights = exp(t(2) - t(8)) = exp(0.2 - 0.8)
    assert abs(v2 / v8 - np.exp(0.2 - 0.8)) < 1e-3


def test_hills_log(tmp_path):
    import os

    os.chdir(tmp_path)
    b = EDMBias(SANITY, dtype=jnp.float64, log_hills=True)
    b.setup(1, 1)
    b.subdivide([0], [10], [0], [10], [True], [0])
    b.add_hills(np.array([[5.0]]), np.array([1.0]))
    b.hills_log.close()
    lines = open("HILLS_0").read().strip().splitlines()
    assert len(lines) == 1
    toks = lines[0].split()
    assert toks[0] == "0" and toks[1] == "h" and toks[2] == "1"
    assert abs(float(toks[3]) - 5.0) < 1e-8  # position
    assert abs(float(toks[4]) - 0.25) < 1e-8  # height
    assert abs(float(toks[5]) - 0.249980997885) < 1e-8  # bias added


def test_oversized_hill_stall_warns(tmp_path):
    """A hill with integral > bias_per_step is deposited and fully undone
    every round (reference-faithful: verified on the compiled binary with
    the reference's own python-example config) — the API warns."""
    import warnings

    p = tmp_path / "stall.edm"
    p.write_text(
        "tempering 0\nhill_prefactor 1.0\ndimension 1\nbox_low 0.0\n"
        "box_high 1.0\nbias_spacing 0.01\nbias_sigma 0.5\n"
    )
    b = EDMBias(str(p), 1, 1, dtype=jnp.float64, log_hills=False)
    b.set_box([0], [1], [True])
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        b.add_hills(np.array([[0.25]]), np.ones(1))
        assert any("bias_per_step" in str(x.message) for x in w)
    # reference-parity: nothing deposited, hill deferred
    assert b.cum_bias == 0.0
    assert b.bias_value([0.25]) == 0.0
    assert int(b.state.buf_right) == 1


def test_hills_log_capped_round_format(tmp_path):
    """Event-stream parity for a capped round: h lines for deposits, a 'u'
    undo for the straddler, zero-height 'h' for capped-out hills, and 'b'
    drain lines on the next round (edm_bias.cpp:586-612 format)."""
    import os

    os.chdir(tmp_path)
    p = tmp_path / "cap.edm"
    p.write_text(CAP_EDM + "hills_filename CAPH\n")
    b = EDMBias(str(p), 1, 1, dtype=jnp.float64, log_hills=True)
    b.subdivide([0], [10], [0], [10], [True], [0])
    b.add_hills(np.array([[2.0], [3.0], [4.0], [5.0], [6.0]]), np.ones(5))
    b.pre_add_hill(1)
    b.post_add_hill()
    b.hills_log.close()

    lines = [l.split() for l in open("CAPH_0").read().strip().splitlines()]
    types_r0 = [l[1] for l in lines if l[0] == "0"]
    assert types_r0 == ["h", "h", "h", "h", "u", "h"]
    # the straddler undo is negative, the capped-out hill logs zero height
    undo = [l for l in lines if l[1] == "u"][0]
    assert float(undo[4]) < 0
    zero_h = [l for l in lines if l[0] == "0" and l[1] == "h"][-1]
    assert float(zero_h[4]) == 0.0
    # round 1 drains both deferred hills as 'b' events with cum/vol > 0
    types_r1 = [l[1] for l in lines if l[0] == "1"]
    assert types_r1 == ["b", "b"]
    assert float([l for l in lines if l[0] == "1"][0][-1]) > 0
