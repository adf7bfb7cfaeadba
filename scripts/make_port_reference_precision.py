"""Write the JAX reference of the port's reduced-precision feature mode.

The JAX package's mode (``precision="bf16" | "mixed"``, the global
``ops/cellblock.py`` ``PIECES`` = 1 | 2) reaches its Pallas kernels only,
which run here in interpret mode (``IMPL="pallas_interpret"``) on the CPU.
There ``Precision.DEFAULT`` is f32: the filter's cotangent products, which
the TPU (and the port) run with bf16 operands at one piece, stay exact.
So at one piece the filter weights are rounded to bf16 before they reach
the JAX side; the port rounds them again in those products (a no-op) and
also rounds the filter cotangent gW and rbf_aug there, which the CPU's
JAX keeps in f32 (the test's tolerance bounds those terms).  Saves, to
``tests/data/port_ref_precision.npz``:

* ``msg/<form>/<pieces>/<name>``: the message op of ``form`` (``full``:
  ``painn_message_columns_full_fused``; ``hybrid``:
  ``painn_message_columns_fm_geores`` on ``column_geometry(...,
  with_d=True)`` under ``stop_gradient``) at ``pieces`` 2 and 1 on the
  case of ``tests/test_colblock.py:641-661`` (90 random atoms in a 10 A
  box, ``RandomState(1)``, F = 32, 12 Gaussians, 3 A cutoff; the filter
  weights rounded to bf16 at one piece): the outputs ``dq``, ``dmu`` and
  the VJP ``gx``, ``gmu``, ``gR``, ``gFW`` for the cotangents ``g_dq`` =
  randn [A', F], ``g_dmu`` = randn [A', 3F] drawn after the inputs;
* ``calc/R``, ``calc/cell``: a 108-atom FCC argon box jittered by a seeded
  +-0.3 A and stretched by 1.1 (``RandomState(1)``);
  ``calc/params/<flax path>``: PaiNN-32x2 (20 Gaussians, 5 A cosine
  cutoff) with an ``Atomwise`` energy and ``Forces``, flax's init from
  ``PRNGKey(0)``, the filter network rounded to bf16;
  ``calc/forces/<fuse>/<precision>``: the JAX ``SchNetPackCalculator``'s
  forces (eV/A) on ``neighbor_list="cellblock"`` with ``FUSE`` = full and
  hybrid at ``precision`` f32, mixed and bf16.

``tests/test_torch_port_precision.py`` holds the port's twins and
calculator to this file.  Run from the repository root (a few minutes on
the CPU, most of it the interpret-mode kernels):

    JAX_PLATFORMS=cpu python scripts/make_port_reference_precision.py
"""
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "tests", "data", "port_ref_precision.npz")

MSG_CUTOFF, MSG_B, MSG_F = 3.0, 12, 32
CALC_CUTOFF, CALC_F, CALC_T, CALC_B = 5.0, 32, 2, 20
PIECES = {"f32": 3, "mixed": 2, "bf16": 1}


def bf16(a):
    """``a`` rounded to bf16 (nearest even), as float32."""
    import jax.numpy as jnp

    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))


def message_case():
    """The inputs of ``tests/test_colblock.py:641-661`` and two
    cotangents, as numpy (the layout from the JAX package's
    ``build_column_layout``)."""
    from schnetpack_tpu.ops.cellblock import build_column_layout

    rng = np.random.RandomState(1)
    R = rng.uniform(0, 10.0, (90, 3))
    cell = np.eye(3) * 10.0
    lay = build_column_layout(R, MSG_CUTOFF + 0.4, cell, np.ones(3, bool))
    Ap, F = len(lay.order), MSG_F
    c = dict(lay=lay,
             Rs=(R[lay.order] * lay.slot_mask[:, None]).astype(np.float32),
             coff_fm=np.moveaxis(lay.offcol, -1, 2).astype(np.float32))
    c["x"] = (rng.randn(Ap, 3 * F) * 0.3).astype(np.float32)
    c["mu"] = (rng.randn(Ap, 3 * F) * 0.3).astype(np.float32)
    c["FW"] = (rng.randn(MSG_B + 1, 3 * F) * 0.3).astype(np.float32)
    c["g_dq"] = rng.randn(Ap, F).astype(np.float32)
    c["g_dmu"] = rng.randn(Ap, 3 * F).astype(np.float32)
    return c


def jax_message(c, form, pieces):
    """(dq, dmu, gx, gmu, gR, gFW) of the JAX message op ``form`` at
    ``pieces`` in interpret mode (the filter weights rounded to bf16 at
    one piece); restores the package's globals."""
    import jax
    import jax.numpy as jnp

    from schnetpack_tpu.ops import cellblock as cb
    from schnetpack_tpu.ops import colblock_geo as jgeo
    from schnetpack_tpu.ops.colblock import (
        ColRefs, painn_message_columns_fm_geores,
        painn_message_columns_full_fused,
    )
    from schnetpack_tpu.ops.radial import gaussian_rbf_params

    refs = ColRefs.from_layout(c["lay"])
    centers, widths = gaussian_rbf_params(MSG_B, MSG_CUTOFF, 0.0)
    cw = jnp.stack([jnp.asarray(centers, jnp.float32),
                    -0.5 / jnp.square(jnp.asarray(widths, jnp.float32))], 1)
    coff = jnp.asarray(c["coff_fm"])

    def full(x, mu, R, fw):
        return painn_message_columns_full_fused(x, mu, R, fw, coff, cw, refs,
                                                MSG_CUTOFF)

    def hybrid(x, mu, R, fw):
        geo = jax.lax.stop_gradient(jgeo.column_geometry(
            R, coff, refs, centers, widths, MSG_CUTOFF, with_d=True))
        return painn_message_columns_fm_geores(x, mu, R, geo, fw, coff, cw,
                                               refs, MSG_CUTOFF)

    old = (cb.IMPL, cb.PIECES, cb.WGRAD)
    cb.IMPL, cb.PIECES, cb.WGRAD = "pallas_interpret", pieces, True
    try:
        FW = bf16(c["FW"]) if pieces == 1 else c["FW"]
        args = [jnp.asarray(a) for a in (c["x"], c["mu"], c["Rs"], FW)]
        out, vjp = jax.vjp(full if form == "full" else hybrid, *args)
        grads = vjp((jnp.asarray(c["g_dq"]), jnp.asarray(c["g_dmu"])))
        return [np.asarray(o) for o in (*out, *grads)]
    finally:
        cb.IMPL, cb.PIECES, cb.WGRAD = old


def calc_box():
    """108 FCC argon atoms, jittered and stretched (``RandomState(1)``)."""
    a, n = 5.26, 3
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    grid = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"),
                    -1).reshape(-1, 1, 3)
    R = ((base[None] + grid) * a).reshape(-1, 3)
    rng = np.random.RandomState(1)
    return ((R + rng.uniform(-0.3, 0.3, R.shape)) * 1.1,
            np.eye(3) * a * n * 1.1)


def jax_potential():
    from schnetpack_tpu.atomistic import Atomwise, Forces
    from schnetpack_tpu.model import NeuralNetworkPotential
    from schnetpack_tpu.representation import PaiNN

    return NeuralNetworkPotential(
        representation=PaiNN(n_atom_basis=CALC_F, n_interactions=CALC_T,
                             n_rbf=CALC_B, cutoff=CALC_CUTOFF),
        input_modules=[], output_modules=[Atomwise(), Forces()])


def molecule(R, cell):
    from schnetpack_tpu import properties as P

    return {P.Z: np.full(len(R), 18, np.int64), P.R: R, P.cell: cell,
            P.pbc: np.ones(3, bool)}


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def calc_params(R, cell):
    """Flax's init of ``jax_potential`` from ``PRNGKey(0)`` on the box's
    column inputs, the filter network rounded to bf16."""
    import jax

    from schnetpack_tpu.md import load_molecules
    from schnetpack_tpu.md.calculators import SchNetPackCalculator

    pot = jax_potential()
    calc = SchNetPackCalculator(pot, None, cutoff=CALC_CUTOFF,
                                neighbor_list="cellblock")
    system = load_molecules([molecule(R, cell)])
    inputs = calc._model_inputs(system, calc.init_state(system))
    tree = jax.device_get(pot.init(jax.random.PRNGKey(0), inputs))
    filt = tree["params"]["representation"]["filter_net"]["linear"]
    for k in filt:
        filt[k] = bf16(filt[k])
    return tree


def jax_forces(tree, R, cell, fuse, precision):
    from schnetpack_tpu.md import load_molecules
    from schnetpack_tpu.md.calculators import SchNetPackCalculator
    from schnetpack_tpu.ops import cellblock as cb

    old = (cb.IMPL, cb.PIECES, cb.FUSE, cb.WGRAD)
    cb.IMPL, cb.FUSE = "pallas_interpret", fuse
    try:
        calc = SchNetPackCalculator(jax_potential(), tree,
                                    cutoff=CALC_CUTOFF,
                                    neighbor_list="cellblock",
                                    precision=precision)
        system = load_molecules([molecule(R, cell)])
        system = calc.calculate(system, calc.init_state(system))
        return np.asarray(system.forces)[0] / calc.force_conversion
    finally:
        cb.IMPL, cb.PIECES, cb.FUSE, cb.WGRAD = old


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    out = {}
    c = message_case()
    names = ("dq", "dmu", "gx", "gmu", "gR", "gFW")
    for form in ("full", "hybrid"):
        for pieces in (2, 1):
            for n, v in zip(names, jax_message(c, form, pieces)):
                out[f"msg/{form}/{pieces}/{n}"] = v
            print(f"message {form} pieces={pieces}", flush=True)
    R, cell = calc_box()
    tree = calc_params(R, cell)
    out["calc/R"], out["calc/cell"] = R, cell
    out.update({f"calc/params/{k}": v for k, v in flat(tree).items()})
    for fuse in ("full", "hybrid"):
        for precision in PIECES:
            out[f"calc/forces/{fuse}/{precision}"] = jax_forces(
                tree, R, cell, fuse, precision)
            print(f"calculator {fuse} {precision}", flush=True)
    for precision in ("mixed", "bf16"):
        f, f3 = (out[f"calc/forces/full/{p}"] for p in (precision, "f32"))
        print(f"{precision} vs f32: max |dF| / max |F| = "
              f"{np.abs(f - f3).max() / np.abs(f3).max():.3e}")
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
