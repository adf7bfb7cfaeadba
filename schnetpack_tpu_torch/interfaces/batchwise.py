"""Batchwise structure relaxation (parity:
``schnetpack_tpu/interfaces/batchwise.py``).

``BatchwiseCalculator`` evaluates energies and forces of a list of
structures in one padded batch on the converter's device (the card unless
the caller asks for the CPU), ``BatchwiseEnsembleCalculator`` the mean of
several models' outputs, and ``batchwise_lbfgs`` relaxes the population
with per-structure convergence masks: the LBFGS two-loop recursion runs on
the host in float64 numpy (a copy of the JAX package's), one model
evaluation a step for the whole population.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import properties as structure
from .ase_interface import AtomsConverter, _host_outputs, _ready, _to_sample


class BatchwiseCalculator:
    """Energies and forces of a list of structures in one batch (parity:
    ``batchwise.py:26-51``); ``model`` (with ``params``, a state dict,
    loaded unless None) is frozen on ``converter.device``."""

    def __init__(self, model, params, converter: AtomsConverter,
                 energy_key: str = structure.energy,
                 force_key: str = structure.forces):
        self.model = _ready(model, params, converter.device)
        self.converter = converter
        self.energy_key = energy_key
        self.force_key = force_key

    def _apply(self, batch) -> Dict[str, np.ndarray]:
        return _host_outputs(self.model, batch)

    def calculate(self, structures: Sequence[Dict]) -> Tuple[np.ndarray, List[np.ndarray]]:
        samples = [_to_sample(s) for s in structures]
        batch = self.converter(samples)
        out = self._apply(batch)
        energies = out[self.energy_key][: len(samples)]
        forces_flat = out[self.force_key]
        forces = []
        off = 0
        for s in samples:
            n = len(s[structure.Z])
            forces.append(forces_flat[off: off + n])
            off += n
        return energies, forces


class BatchwiseEnsembleCalculator(BatchwiseCalculator):
    """The members' mean of every output (parity: ``batchwise.py:54-66``):
    ``models``, one loaded potential per member."""

    def __init__(self, models: Sequence, converter: AtomsConverter,
                 **kwargs):
        super().__init__(models[0], None, converter, **kwargs)
        self.models = [_ready(m, None, converter.device) for m in models]

    def _apply(self, batch) -> Dict[str, np.ndarray]:
        runs = []
        with torch.no_grad():
            for m in self.models:
                runs.append(m(batch))
        out = {}
        for k, v in runs[0].items():
            if torch.is_tensor(v):
                x = torch.stack([r[k] for r in runs])
                out[k] = (x.mean(0) if x.is_floating_point() else x[0]
                          ).cpu().numpy()
        return out


def batchwise_lbfgs(
    calculator: BatchwiseCalculator,
    structures: Sequence[Dict],
    fmax: float = 0.01,
    maxstep_total: int = 200,
    memory: int = 25,
    maxstep: float = 0.2,
    damping: float = 1.0,
    alpha: float = 70.0,
    fixed_atoms_mask: Optional[np.ndarray] = None,
    verbose: bool = False,
    trajectory: Optional[str] = None,
    logfile: Optional[str] = None,
) -> Tuple[List[Dict], Dict]:
    """Relax a population of structures with memory-limited BFGS.

    Returns the relaxed structures and an info dict with per-structure
    convergence flags and iteration counts.

    On-disk artifacts (parity: the reference's ASE optimizer trajectory +
    logfile, ase_interface.py:759-800): ``trajectory`` writes every
    optimizer iteration as an ASE-compatible extxyz trajectory (one file
    per structure, ``<base>_m<i>.extxyz`` when more than one structure is
    relaxed) with energies and forces in the frames; ``logfile`` appends
    classic ``Step Energy fmax`` optimizer lines.
    """
    samples = [_to_sample(s) for s in structures]
    n_atoms = [len(s[structure.Z]) for s in samples]
    total = sum(n_atoms)
    mol_of_atom = np.repeat(np.arange(len(samples)), n_atoms)

    x = np.concatenate([np.asarray(s[structure.R], np.float64) for s in samples])
    move_mask = np.ones((total, 1))
    if fixed_atoms_mask is not None:
        move_mask[np.asarray(fixed_atoms_mask)] = 0.0

    def eval_forces(x_flat):
        off = 0
        current = []
        for s, n in zip(samples, n_atoms):
            s2 = dict(s)
            s2[structure.R] = x_flat[off: off + n]
            current.append(s2)
            off += n
        e, f_list = calculator.calculate(current)
        return e, np.concatenate(f_list) * move_mask

    # Per-sample curvature (parity: batchwise_optimization.py:613-917 keeps
    # an independent Hessian approximation per structure): the history
    # vectors are shared arrays, but every inner product of the two-loop
    # recursion is a *segment* dot over each molecule's own atoms, with a
    # per-molecule rho.  This is exactly block-diagonal L-BFGS — molecule m
    # takes the same steps it would if relaxed alone.
    M = len(samples)
    mol3 = np.repeat(mol_of_atom, 3)  # molecule id per flattened coordinate

    def segdot(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        return np.bincount(mol3, weights=a * b, minlength=M)

    s_hist: List[np.ndarray] = []
    y_hist: List[np.ndarray] = []
    rho: List[np.ndarray] = []  # per-molecule [M]; 0 where curvature invalid

    e, f = eval_forces(x)
    converged = np.zeros(M, bool)
    iterations = np.zeros(M, int)
    H0 = 1.0 / alpha

    def _traj_paths():
        if M == 1:
            return [trajectory]
        import os as _os

        base, ext = _os.path.splitext(trajectory)
        return [f"{base}_m{m}{ext or '.extxyz'}" for m in range(M)]

    def _record(it, first=False):
        if trajectory is not None:
            from ..datasets.xyz import write_extxyz

            off = 0
            for m, (s, n, p) in enumerate(zip(samples, n_atoms,
                                              _traj_paths())):
                cell = np.asarray(s.get(structure.cell, np.zeros((3, 3))))
                write_extxyz(p, [{
                    "numbers": np.asarray(s[structure.Z]),
                    "positions": x[off: off + n],
                    "cell": cell if np.any(cell) else None,
                    "energy": float(np.asarray(e).ravel()[m]),
                    "forces": f[off: off + n],
                }], append=not first)
                off += n
        if logfile is not None:
            with open(logfile, "a" if not first else "w") as lf:
                if first:
                    lf.write("BatchwiseLBFGS  Step  Energy[mean]  fmax\n")
                lf.write(
                    f"BatchwiseLBFGS: {it:4d}  "
                    f"{float(np.mean(np.asarray(e))):16.6f}  "
                    f"{np.abs(f).max():12.6f}\n"
                )

    _record(0, first=True)

    for it in range(maxstep_total):
        fnorm_per_mol = np.array(
            [np.abs(f[mol_of_atom == m]).max() if (mol_of_atom == m).any() else 0.0
             for m in range(M)]
        )
        newly = fnorm_per_mol < fmax
        iterations[~converged & ~newly] = it
        converged = converged | newly
        if converged.all():
            break

        # block-diagonal two-loop recursion on -grad = f
        q = f.reshape(-1).copy()
        a_coeffs = []
        for s_v, y_v, r in zip(reversed(s_hist), reversed(y_hist), reversed(rho)):
            a_c = r * segdot(s_v, q)          # [M]
            q -= a_c[mol3] * y_v
            a_coeffs.append(a_c)
        z = H0 * q
        for s_v, y_v, r, a_c in zip(s_hist, y_hist, rho, reversed(a_coeffs)):
            b_c = r * segdot(y_v, z)          # [M]
            z += s_v * (a_c - b_c)[mol3]
        step = z.reshape(total, 3) * damping
        # freeze converged molecules, clip per-atom step length
        frozen = converged[mol_of_atom]
        step[frozen] = 0.0
        lengths = np.linalg.norm(step, axis=1, keepdims=True)
        step = step * np.minimum(1.0, maxstep / np.maximum(lengths, 1e-12))

        x_new = x + step
        e_new, f_new = eval_forces(x_new)

        s_v = (x_new - x).reshape(-1)
        y_v = (f - f_new).reshape(-1)  # y = grad_new - grad_old = -(f_new - f)
        sy = segdot(s_v, y_v)          # per-molecule curvature [M]
        ok = sy > 1e-10
        if ok.any():
            # molecules with invalid/zero curvature this step (incl. frozen
            # ones, whose s_v is exactly 0) get rho=0 — the pair is inert
            # for them in every future recursion
            mask3 = ok[mol3]
            s_hist.append(np.where(mask3, s_v, 0.0))
            y_hist.append(np.where(mask3, y_v, 0.0))
            rho.append(np.where(ok, 1.0 / np.where(ok, sy, 1.0), 0.0))
            if len(s_hist) > memory:
                s_hist.pop(0)
                y_hist.pop(0)
                rho.pop(0)
        x, e, f = x_new, e_new, f_new
        _record(it + 1)
        if verbose:
            print(f"lbfgs it {it}: fmax={fnorm_per_mol.max():.4f} converged={converged.sum()}/{len(samples)}")

    out_structs = []
    off = 0
    for s, n in zip(samples, n_atoms):
        s2 = dict(s)
        s2[structure.R] = x[off: off + n]
        off += n
        out_structs.append(s2)
    info = {
        "converged": converged,
        "iterations": iterations,
        "energies": e,
        "fmax": np.array(
            [np.abs(f[mol_of_atom == m]).max() for m in range(len(samples))]
        ),
    }
    return out_structs, info


#: reference-compatible alias
ASEBatchwiseLBFGS = batchwise_lbfgs
