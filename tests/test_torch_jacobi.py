"""The Jacobi PSD projection of cosmo_tpu_torch (ops/jacobi_proj.py).

On the CPU the wrapper runs the kernel's plain PyTorch version; it is held
here to ``cosmo_tpu.ops.eigh.psd_project_jacobi(X, sweeps, "vec")``, the JAX
package's implementation of the same round-robin schedule (the serial
Pallas kernel has no interpret mode and falls back to eigh off-TPU, so it
cannot be the reference here). The CUDA kernel itself is held to the plain
version on the card by tests/test_torch_cuda.py and chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cosmo_tpu.ops import eigh as jeigh
from cosmo_tpu_torch.ops import jacobi_proj as J

from _torch_port import eigh_projection, sym_stack

torch.set_num_threads(1)


@pytest.mark.parametrize("k", [4, 8, 16, 48])
def test_plain_matches_jax_jacobi(k):
    """f64, same schedule and guards; only the order of the k/2 disjoint
    rotations inside a round may round differently: <= 1e-10. One JAX
    call at B = 130 gives the reference for every B (blocks are
    independent)."""
    X = sym_stack(130, k, seed=k)
    ref = np.asarray(jeigh.psd_project_jacobi(jnp.asarray(X), 8, "vec"))
    for B in (1, 7, 130):
        got = J.psd_project_pallas(torch.as_tensor(X[:B]), 8).numpy()
        assert got.shape == (B, k, k)
        assert np.abs(got - ref[:B]).max() <= 1e-10


def test_plain_matches_eigh_projection():
    """10 sweeps reach f64 eigh accuracy: <= 1e-9, as tests/test_eigh.py."""
    X = sym_stack(24, 16, seed=3)
    got = J.psd_project_jacobi_plain(torch.as_tensor(X), 10).numpy()
    assert np.abs(got - eigh_projection(X)).max() <= 1e-9


@pytest.mark.parametrize("k", [8, 16])
def test_f32_within_documented_floor(k):
    """f32 Jacobi carries a ~1e-5 relative backward-error floor
    (cosmo_tpu/ops/conedata.py resolve_eigh_backend: 6e-6 at k = 8,
    1.7e-5 at k = 16): the f32 projection stays within 2e-5 of the f64 one,
    relative to the input's largest entry."""
    X = sym_stack(64, k, seed=11)
    y64 = J.psd_project_jacobi_plain(torch.as_tensor(X), 8).numpy()
    y32 = J.psd_project_pallas(torch.as_tensor(X, dtype=torch.float32), 8)
    assert y32.dtype == torch.float32
    assert np.abs(y32.double().numpy() - y64).max() <= 2e-5 * np.abs(X).max()


@pytest.mark.parametrize("k", [2, 5, 50])
def test_shape_rule_sends_other_sides_to_eigh(k):
    """Odd k, k < 4 and k > 48 are outside the kernel's domain
    (pallas_eigh.py:257-266): exact eigh projection, f64 1e-12."""
    assert not J.kernel_takes(k)
    X = sym_stack(5, k, seed=k)
    got = J.psd_project_pallas(torch.as_tensor(X), 8).numpy()
    assert np.abs(got - eigh_projection(X)).max() <= 1e-12


def test_domain_rule():
    assert [k for k in range(1, 60) if J.kernel_takes(k)] == list(range(4, 49, 2))


def test_cpu_tensor_never_counts_a_launch():
    before = J.psd_project_pallas.launches
    J.psd_project_pallas(torch.as_tensor(sym_stack(3, 8, seed=0)), 8)
    J.psd_project_pallas(torch.as_tensor(sym_stack(3, 5, seed=0)), 8)
    assert J.psd_project_pallas.launches == before


def test_pair_schedule_matches_reference():
    from cosmo_tpu.ops import pallas_eigh

    for k in (4, 16, 48):
        assert np.array_equal(J.pair_schedule(k), pallas_eigh._pair_schedule(k))


def test_cuda_entry_refuses_a_cpu_tensor():
    with pytest.raises(ValueError):
        J.jacobi_proj_cuda(torch.as_tensor(sym_stack(2, 8, seed=0)), 8)


def test_library_path_hashes_the_included_headers(tmp_path):
    """The kernels' library name changes when a header its sources include
    from csrc/ changes, or one of its sources, so an edited file never
    loads a stale build."""
    import shutil

    from cosmo_tpu_torch.ops import cuda_build

    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    for name in cuda_build.JACOBI_SOURCES:
        # the large-side kernels share their rounding, not the round-parallel
        # design; the cluster and the grid kernel also the circle's geometry
        headers = {"jacobi_eig_large.cu": ["jacobi_rn.cuh"],
                   "jacobi_eig_cluster.cu": ["jacobi_circle.cuh", "jacobi_rn.cuh"],
                   "jacobi_eig_grid.cu": ["jacobi_circle.cuh", "jacobi_rn.cuh"]}.get(
                       name, ["jacobi_rounds.cuh"])
        assert [p.name for p in cuda_build._sources(csrc / name)] == [name, *headers]

    def path():
        return cuda_build.library_path([csrc / n for n in cuda_build.JACOBI_SOURCES],
                                       "jacobi")

    before = path()
    assert before == cuda_build.library_path(
        [cuda_build.CSRC / n for n in cuda_build.JACOBI_SOURCES], "jacobi")
    header = csrc / "jacobi_rounds.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = path()
    assert edited != before
    smem = csrc / "jacobi_smem.cu"
    smem.write_text(smem.read_text() + "\n// edited\n")
    edited_smem = path()
    assert edited_smem not in (before, edited)
    large = csrc / "jacobi_eig_large.cu"
    large.write_text(large.read_text() + "\n// edited\n")
    edited_large = path()
    assert edited_large not in (before, edited, edited_smem)
    rn = csrc / "jacobi_rn.cuh"
    rn.write_text(rn.read_text() + "\n// edited\n")
    assert path() not in (before, edited, edited_smem, edited_large)


_FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
out = args[args.index("-o") + 1]
with open({calls!r}, "a") as f:
    f.write(" ".join(args) + "\\n")
if "-c" in args:
    src = args[-1]
    if "broken" in open(src).read():
        print(src + ": error")
        sys.exit(1)
    print("ptxas info : compiled " + src)
open(out, "w").write("built")
"""


def test_build_compiles_each_source_then_links_once(tmp_path, monkeypatch):
    """build() starts one ``nvcc -c`` per source and links their objects
    into one library (a stand-in nvcc here: no CUDA toolkit on the CPU),
    keeps every compiler report in the .log, leaves no object behind,
    reuses a built library, and raises naming a source that fails."""
    import sys

    from cosmo_tpu_torch.ops import cuda_build

    calls = tmp_path / "calls.txt"
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable, calls=str(calls)))
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    sources = [tmp_path / f"{n}.cu" for n in ("a", "b", "c")]
    for src in sources:
        src.write_text(f"// {src.stem}\n")

    so = cuda_build.build(sources, "fake")
    assert so.read_text() == "built" and so.parent == tmp_path / "build"
    lines = calls.read_text().splitlines()
    assert sorted(line.split()[-1] for line in lines[:3]) == [str(s) for s in sources]
    assert all("-c" in line.split() for line in lines[:3])
    assert "-shared" in lines[3].split() and len(lines) == 4
    assert all(f"compiled {s}" in so.with_suffix(".log").read_text() for s in sources)
    assert not list((tmp_path / "build").glob("*.o"))
    assert cuda_build.build(sources, "fake") == so
    assert len(calls.read_text().splitlines()) == 4

    sources[1].write_text("broken\n")
    with pytest.raises(RuntimeError, match="b.cu"):
        cuda_build.build(sources, "fake")
    assert not cuda_build.library_path(sources, "fake").is_file()
    assert not list((tmp_path / "build").glob("*.o"))


def test_build_passes_a_variant_define_to_nvcc(tmp_path, monkeypatch):
    """build() with extra flags (a variant of a source, as
    ``cuda_build.variant_library`` builds one) hands them to each ``nvcc
    -c`` and gives the variant a library of its own beside the plain
    build."""
    import sys

    from cosmo_tpu_torch.ops import cuda_build

    calls = tmp_path / "calls.txt"
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable, calls=str(calls)))
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    source = tmp_path / "a.cu"
    source.write_text("// a\n")

    plain = cuda_build.build([source], "a")
    variant = cuda_build.build([source], "a", ("-DA_WAIT_NS=0",))
    assert plain.is_file() and variant.is_file() and variant != plain
    assert variant == cuda_build.library_path([source], "a", ("-DA_WAIT_NS=0",))
    compiles = [line.split() for line in calls.read_text().splitlines() if " -c " in line]
    assert ["-DA_WAIT_NS=0" in args for args in compiles] == [False, True]


def test_register_body_takes_every_side_the_auto_rule_sends():
    """The auto rule sends sides <= AUTO_KERNEL_MAX_SIDE to the kernels;
    the kernels' register body (jacobi_rounds.cuh) takes all of them."""
    import re

    from cosmo_tpu_torch.ops import conedata, cuda_build

    text = (cuda_build.CSRC / "jacobi_rounds.cuh").read_text()
    register_max = int(re.search(r"kMaxRegSide = (\d+);", text).group(1))
    assert conedata.AUTO_KERNEL_MAX_SIDE <= register_max
    assert J.kernel_takes(register_max)
