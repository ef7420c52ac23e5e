"""Test config.

The distributed code paths are tested on a simulated mesh of 8 virtual
CPU devices (`--xla_force_host_platform_device_count=8`), the same
shard_map code and collectives as on real devices (SURVEY.md §4 item 3).
The flag must be set before the first JAX backend starts.

    JAX_PLATFORMS=cpu python -m pytest tests/ -q   # CPU suite
    python -m pytest tests/ -m gpu -q              # on the GPU

Tests marked `gpu` take the `gpu` fixture, which skips them unless JAX's
default backend is a GPU; the decision is made when the test runs, never
while a module is imported.
"""

import os

import numpy as np
import pytest

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()


@pytest.fixture
def gpu():
    """The first GPU device; skips the test anywhere else."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run `python -m pytest tests/ -m "
                    "gpu` on the card)")
    return jax.devices()[0]


# Seeded sem_2d stand-ins for the reference's SEM pressure-Poisson test
# matrices (SURVEY.md §2.1): the order-2 mesh whose n is nearest the
# original's, and a diagonal shift that puts the condition number near
# the measured one (λmax ≈ 65, so cond ≈ 65 / shift). Name ->
# (elements per side, seed, shift). Written with base 1, as the
# reference files are.
REFERENCE_STANDINS = {
    "xn3b_A_18.txt": (29, 0, 0.02),    # n 3,481 (3,461); cond ~3e3 (3.2e3)
    "xn3b_A_10.txt": (40, 0, 0.02),    # n 6,561 (6,408)
    "tj7a_A_18.txt": (30, 1, 2.6e-3),  # n 3,721 (3,707); cond ~2.5e4
}


def reference_standin(name: str):
    """The CsrMatrix behind a stand-in file name."""
    from lsbench_tpu.matrix.generate import sem_2d
    ne, seed, shift = REFERENCE_STANDINS[name]
    return sem_2d(ne, 2, shift=shift, seed=seed)


@pytest.fixture(scope="session")
def ref_data_dir(tmp_path_factory):
    """A directory holding the reference's test-file names: the tiny
    closed-form matrices and seeded sem_2d stand-ins for the SEM ones."""
    from lsbench_tpu.matrix.io import write_matrix
    d = tmp_path_factory.mktemp("reference")
    (d / "I1_05x05.txt").write_text(
        "5 1\n" + "".join(f"{i} {i} {float(i)}\n" for i in range(1, 6)))
    for name in REFERENCE_STANDINS:
        write_matrix(reference_standin(name), d / name, base=1)
    return d


@pytest.fixture
def tiny_matrix_file(tmp_path):
    """I1_05x05-equivalent: diag(1..5), base 1 (tests/I1_05x05.txt)."""
    p = tmp_path / "diag5.txt"
    lines = ["5 1"] + [f"{i} {i} {float(i)}" for i in range(1, 6)]
    p.write_text("\n".join(lines) + "\n")
    return p


@pytest.fixture
def base_pair_files(tmp_path):
    """The same 2x2 matrix in base-0 and base-1 form (tests/A0_02x02.txt vs
    tests/A1_02x02.txt fixture role)."""
    a0 = tmp_path / "a0.txt"
    a0.write_text("4 0\n0 0 1\n0 1 1\n1 0 1\n1 1 -1\n")
    a1 = tmp_path / "a1.txt"
    a1.write_text("4 1\n1 1 1\n1 2 1\n2 1 1\n2 2 -1\n")
    return a0, a1


def make_rhs(n):
    """Reference RHS convention r[i]=i (lsbench.c:158-160)."""
    return np.arange(n, dtype=np.float64)
