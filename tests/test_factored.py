"""out_layout="factored": rank-1 (profile ⊗ symbol-rotation) serving output.

The dense grid is exactly rank-1 in time per hop when time_interp is off, so the
factored output must reconstruct the reference-layout grid bit-for-bit (same
factors, same multiply) at ~n_sym x less output.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from srsran_ce.models import estimator
from srsran_ce.utils import synthetic


def _run(case, n_layers, **build_kw):
    fn = estimator.build_ri(case.hop1, case.hop2, case.config, n_layers, **build_kw)
    return fn(
        estimator.split_ri(case.received_rg),
        estimator.split_ri(case.pilots),
        jnp.asarray(case.beta),
    )


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(n_prbs=24, n_layers=2, cfo_hz=300.0),
        dict(n_prbs=16, n_layers=2, two_hops=True, cfo_hz=150.0),
        dict(n_prbs=24, n_layers=4, smoothing="wiener", cfo_hz=0.0, cfo_compensate=False),
        dict(n_prbs=12, n_layers=1, interp="cnn", cnn_alpha=0.4),
    ],
)
def test_factored_reconstructs_ref_grid(kwargs):
    n_layers = kwargs["n_layers"]
    case = synthetic.make_case(seed=13, snr_db=25.0, **kwargs)
    r_ref = _run(case, n_layers, out_layout="ref")
    r_fac = _run(case, n_layers, out_layout="factored")

    n_hops = 2 if kwargs.get("two_hops") else 1
    prof = estimator.merge_ri(np.asarray(r_fac.profiles))
    rot = estimator.merge_ri(np.asarray(r_fac.sym_rot))
    assert prof.shape[0] == n_hops and prof.shape[1] == n_layers
    assert rot.shape == (14,)

    grid = estimator.reconstruct_factored(prof, rot, case.hop1, case.hop2)
    ch_ref = estimator.merge_ri(np.asarray(r_ref.channel_est_rg))
    # exact where sym_rot == 1; elsewhere numpy's and XLA's complex products
    # differ by <= 1 ulp
    np.testing.assert_allclose(grid, ch_ref, rtol=1e-13, atol=0)
    for f in ("noise_est", "rsrp", "epre", "time_alignment", "cfo_hz"):
        np.testing.assert_array_equal(
            np.asarray(getattr(r_fac, f)), np.asarray(getattr(r_ref, f))
        )


def test_factored_batched():
    case = synthetic.make_case(seed=5, n_prbs=24, n_layers=2, snr_db=30.0, cfo_hz=200.0)
    batch = 3
    rg = np.stack(
        [
            estimator.split_ri(
                synthetic.make_case(
                    seed=5 + b, n_prbs=24, n_layers=2, snr_db=30.0, cfo_hz=200.0
                ).received_rg
            )
            for b in range(batch)
        ]
    )
    pil = np.stack(
        [
            estimator.split_ri(
                synthetic.make_case(
                    seed=5 + b, n_prbs=24, n_layers=2, snr_db=30.0, cfo_hz=200.0
                ).pilots
            )
            for b in range(batch)
        ]
    )
    beta = np.ones(batch, rg.dtype)
    f_ref = estimator.build_ri(case.hop1, case.hop2, case.config, 2, batched=True)
    f_fac = estimator.build_ri(
        case.hop1, case.hop2, case.config, 2, batched=True, out_layout="factored"
    )
    r_ref = f_ref(rg, pil, beta)
    r_fac = f_fac(rg, pil, beta)
    prof = estimator.merge_ri(np.moveaxis(np.asarray(r_fac.profiles), 1, 0))
    rot = estimator.merge_ri(np.moveaxis(np.asarray(r_fac.sym_rot), 1, 0))
    assert prof.shape == (batch, 1, 2, case.received_rg.shape[0])
    grid = estimator.reconstruct_factored(prof, rot, case.hop1, case.hop2)
    ch_ref = estimator.merge_ri(np.moveaxis(np.asarray(r_ref.channel_est_rg), 1, 0))
    np.testing.assert_allclose(grid, ch_ref, rtol=1e-13, atol=0)


def test_factored_rejects_time_interp():
    case = synthetic.make_case(seed=1, n_prbs=12, n_layers=1)
    cfg = dataclasses.replace(case.config, time_interp="linear")
    with pytest.raises(ValueError):
        estimator.build_ri(case.hop1, case.hop2, cfg, 1, out_layout="factored")


def test_factored_output_is_nsym_smaller():
    case = synthetic.make_case(seed=2, n_prbs=52, n_layers=2)
    r_ref = _run(case, 2, out_layout="ref")
    r_fac = _run(case, 2, out_layout="factored")
    dense = np.asarray(r_ref.channel_est_rg).size
    fac = np.asarray(r_fac.profiles).size + np.asarray(r_fac.sym_rot).size
    assert fac * 10 < dense  # ~14x for a full slot
