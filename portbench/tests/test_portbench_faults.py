"""The judgement fails a run whose timed path is broken underneath.

Each test drives a whole run on the CPU at a tiny ring (everything but the
look for a card) with one fault planted in the program, and sees `correct`
come out false: a step that returns its state unchanged, half of the batch
left out, an answer altered where it is produced, the exchange between
cards left out (the mesh mix); and, for the preimages,
the faults of `portbench/faults.py`, whose answers still solve A x = U
exactly: the perturbation left out, a trapdoor drawn too narrow. The
control (every output held with one bit less) is in
test_portbench_harness.py.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.faults import FAULTS  # noqa: E402
from portbench.harness import run_cell  # noqa: E402
from portbench.tests.test_portbench_harness import SEED, tiny_bench  # noqa: E402


def _zeros(x):
    return type(x)(x.data * 0, x.fmt, x.params)


def _half(x):
    half = x.ncol // 2
    data = x.data.clone()
    data[:, :, x.ncol - half:] = data[:, :, :half]
    return type(x)(data, x.fmt, x.params)


def _altered(x):
    data = x.data.clone()
    data[0, 0, 0, 0] = (data[0, 0, 0, 0] + 1) % int(x.params.moduli[0])
    return type(x)(data, x.fmt, x.params)


PREIMAGE_MIXES = ["preimage_2col", "preimage_50col", "preimage_mesh4"]


@pytest.mark.parametrize("fault", [_zeros, _half, _altered], ids=["unchanged", "half", "altered"])
@pytest.mark.parametrize("mix", PREIMAGE_MIXES)
def test_preimage_fault_is_not_correct(tmp_path, monkeypatch, mix, fault):
    from mxx_tpu_torch.sampler.trapdoor import TrapdoorSampler

    # the body of both entries, `preimage` and `preimage_batched_sharded`
    real = TrapdoorSampler._preimage_cols

    def broken(self, *args):
        return fault(real(self, *args))

    monkeypatch.setattr(TrapdoorSampler, "_preimage_cols", broken)
    spec = tiny_bench(tmp_path, (mix,))
    assert not run_cell(spec, f"tiny.{mix}", SEED, 0.3, False, device_type="cpu")["correct"]


def test_mesh_gather_left_out_is_not_correct(tmp_path, monkeypatch):
    """Card 0 keeps its own shard, and the columns of the other cards' shards
    never arrive: they are left as card 0 allocated them."""
    from mxx_tpu_torch.parallel.mesh import COL_AXIS
    from mxx_tpu_torch.sampler.trapdoor import TrapdoorSampler

    real = TrapdoorSampler._preimage_cols
    seen = []

    def broken(self, params, trapdoor, public, target, mesh=None):
        x = real(self, params, trapdoor, public, target, mesh)
        seen.append(mesh.shape[COL_AXIS])
        data = x.data.clone()
        data[:, :, x.ncol // mesh.shape[COL_AXIS]:] = 0
        return type(x)(data, x.fmt, x.params)

    monkeypatch.setattr(TrapdoorSampler, "_preimage_cols", broken)
    spec = tiny_bench(tmp_path, ("preimage_mesh4",))
    r = run_cell(spec, "tiny.preimage_mesh4", SEED, 0.3, False, device_type="cpu")
    assert seen and set(seen) == {4}
    assert not r["correct"] and r["checks"]["ax_mismatch"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("mix", PREIMAGE_MIXES)
def test_preimage_of_a_narrowed_sampler_is_not_correct(tmp_path, mix, fault):
    spec = tiny_bench(tmp_path, (mix,))
    with FAULTS[fault]():
        r = run_cell(spec, f"tiny.{mix}", SEED, 0.3, False, device_type="cpu")
    checks = r["checks"]
    assert checks["ax_mismatch"]["value"] == 0 and checks["lift_mismatch"]["value"] == 0
    assert checks["a_rebuild_mismatch"]["value"] == 0
    assert not r["correct"], checks


def _inputs_back(outs, encs):
    return list(encs[1:1 + len(outs)])


def _half_outputs(outs, encs):
    half = len(outs) // 2
    return outs[:len(outs) - half] + outs[:half]


def _altered_output(outs, encs):
    from mxx_tpu_torch.bgg import BggEncoding

    o = outs[0]
    return [BggEncoding(_altered(o.vector), o.pubkey, o.plaintext)] + list(outs[1:])


@pytest.mark.parametrize("fault", [_inputs_back, _half_outputs, _altered_output],
                         ids=["unchanged", "half", "altered"])
def test_bgg_fault_is_not_correct(tmp_path, monkeypatch, fault):
    from mxx_tpu_torch.circuit import batched_eval

    real = batched_eval.eval_batched

    def broken(circuit, params, one, inputs, *args, **kw):
        return fault(real(circuit, params, one, inputs, *args, **kw), [one] + list(inputs))

    monkeypatch.setattr(batched_eval, "eval_batched", broken)
    spec = tiny_bench(tmp_path, ("bgg_encoding_pass",))
    r = run_cell(spec, "tiny.bgg_encoding_pass", SEED, 0.3, False, device_type="cpu")
    assert not r["correct"]


def test_bgg_passes_share_no_inputs(tmp_path):
    """Each pass draws its wires from the pool afresh: no two passes of a
    window of thousands hand the program the same inputs."""
    from portbench.drivers.bgg_pass import BggPassDriver
    from portbench.harness import Context

    spec = tiny_bench(tmp_path, ("bgg_encoding_pass",))
    cell = spec.cell("tiny.bgg_encoding_pass")
    mix = spec.traffic(cell["traffic"])
    driver = BggPassDriver(Context(spec.config("tiny"), mix, SEED, "cpu", 1))
    driver.pool = [None] * mix["input_sets"]
    draws = {tuple(driver.draw(i)) for i in range(5000)}
    assert len(draws) == 5000
    assert {j for d in draws for j in d} == set(range(mix["input_sets"]))
