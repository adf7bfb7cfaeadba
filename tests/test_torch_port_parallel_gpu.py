"""PyTorch port, the slab path's halo'd kernels on two ranks of one card
(skipped without CUDA).  No jax import: on a machine without jax run
``python -m pytest --noconftest -m gpu tests/test_torch_port_parallel_gpu.py``.

Two gloo ranks on ``cuda:0`` (``make_column_mesh(2, device="cuda",
backend="gloo")``: the halo planes cross through host buffers) each hold
an x slab of nx_loc = 5 columns of an FCC argon box on a (10, 10) grid:
K11/K12 (the halo'd gather and its VJP) and K20/K21 (the row-12 message
and its VJP) on the halo planes of the other rank, against the twins'
route on the CPU over the same mesh, at the kernel tests' tolerance
(K11, a copy, bit for bit), with one launch of each kernel a rank.
"""
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from schnetpack_tpu_torch.ops import _build
from schnetpack_tpu_torch.ops.cellblock import build_column_layout
from schnetpack_tpu_torch.parallel import spawn_ranks
from torch_port_cases import fcc_argon

GRID = (10, 10, 1)        # two ranks: nx_loc = 5
CUTOFF = 4.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("F,B", [(32, 8), (128, 20)])
def test_halod_kernels_on_two_ranks_match_twin(cuda_device, tmp_path, F, B):
    _build.lib()      # the ranks load the library built here
    R, cell = fcc_argon(8, jitter=0.2, seed=F)
    lay = build_column_layout(R, CUTOFF, cell, np.ones(3, bool), dims=GRID)
    res = spawn_ranks(workers.halo_kernels, 2, (lay, F, B, F), str(tmp_path))
    for errs, launches, nxl in res:
        assert nxl == 5
        for name, (err, scale, close) in errs.items():
            assert close, (name, err, scale)
            assert scale > 0, name
        assert errs["K11"][0] == 0.0
        assert launches["gather_fwd"] == 1 and launches["gather_bwd"] == 1
        assert launches["msg_fwd_edge"] == 1
        assert launches["msg_bwd_edge"] == 1
