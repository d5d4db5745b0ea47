"""Closed loop of trapdoor preimages: one request in flight.

Set-up makes one trapdoor through the program (`TrapdoorSampler.trapdoor`)
and warms the call up at the cell's shape (the kernels build or load, the
sampler caches its operands). Request i is a preimage of a fresh uniform
target of `cols` columns drawn from the run's seed and i, through
`TrapdoorSampler.preimage`. The client holds its last answer while the next
is computed.

On a cell of more than one chip, its cards form one row of a
`parallel.Mesh` on its `col` axis, and request i goes through the port's
sharded entry, `TrapdoorSampler.preimage_batched_sharded`: the target's
columns split over the cards (the program pads them to a multiple of the
cards), each card computes its shard, and the answer is gathered onto card
0, which holds the trapdoor.
"""

from __future__ import annotations

import time

import torch

from ..reference import preimage as judge
from ..reference.ring import Ring, crt_moduli
from .common import RING_SCHEMA, Keeper, generator, sub_seed, uniform_residues


class PreimageDriver:
    MIX_SCHEMA = {
        "required": ["cols"],
        "properties": {"cols": {"type": "integer", "minimum": 1}},
    }
    CONFIG_SCHEMA = {
        "required": ["ring", "d", "trapdoor_sigma"],
        "properties": {
            "ring": RING_SCHEMA,
            "d": {"type": "integer", "minimum": 1},
            "trapdoor_sigma": {"type": "number", "minimum": 0},
        },
    }

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.mix = ctx.cfg, ctx.mix
        self.cols = self.mix["cols"]
        self.dev = ctx.device(0)
        self.mesh = None

    def setup(self) -> None:
        from mxx_tpu_torch.parallel.mesh import Mesh
        from mxx_tpu_torch.ring.params import RingParams
        from mxx_tpu_torch.sampler.trapdoor import TrapdoorSampler

        ctx, r = self.ctx, self.cfg["ring"]
        if ctx.chips > 1:
            # one row of cards on `col`: make_mesh(4) would factor 4 into
            # limb shards, and every column shard would land on card 0
            self.mesh = Mesh([[ctx.device(j) for j in ctx.indices]])
        self.params = RingParams.new(r["ring_dimension"], r["crt_depth"], r["crt_bits"],
                                     r["base_bits"])
        self.moduli = torch.tensor(crt_moduli(r["ring_dimension"], r["crt_depth"], r["crt_bits"]),
                                   dtype=torch.int64, device=self.dev)
        base = ctx.memory_allocated()
        t0 = time.perf_counter()
        self.sampler = TrapdoorSampler(self.params, self.cfg["trapdoor_sigma"],
                                       seed=sub_seed(ctx.seed, "trapdoor"), device=self.dev)
        self.trapdoor, self.public = self.sampler.trapdoor(self.params, self.cfg["d"])
        ctx.sync()
        t1 = time.perf_counter()
        for i in range(self.mix.get("warmup", 1)):
            x = self.request(-1 - i)
        ctx.sync()
        t2 = time.perf_counter()
        self.keeper = Keeper(self.dev, self.mix["keep_every"], self.mix["keep_slots"],
                             sub_seed(ctx.seed, "keep") % self.mix["keep_every"])
        self.keeper.allocate([x.data])
        del x
        self.setup_split_s = {"trapdoor": t1 - t0, "warmup": t2 - t1,
                              "pinned_buffers": time.perf_counter() - t2}
        self.held_bytes = max(a - b for a, b in zip(ctx.memory_allocated(), base))

    def target(self, i: int):
        from mxx_tpu_torch.matrix import PolyMatrix
        from mxx_tpu_torch.ring.poly import COEFF

        g = generator(self.dev, sub_seed(self.ctx.seed, "target", i))
        data = uniform_residues(self.moduli, (self.cfg["d"], self.cols, self.params.n), g)
        return PolyMatrix(data, COEFF, self.params)

    def request(self, i: int):
        if self.mesh is None:
            return self.sampler.preimage(self.params, self.trapdoor, self.public, self.target(i))
        return self.sampler.preimage_batched_sharded(self.params, self.trapdoor, self.public,
                                                     [self.target(i)], self.mesh)[0]

    def keep(self, i: int, x, force: bool = False) -> None:
        if self.keeper.wants(i) or force:  # wanted ones are kept in the window
            self.keeper.keep((i, x.fmt), [x.data])

    def end_to_end(self, window_s: float, done: int) -> dict:
        return {"preimage_cols_per_s": done * self.cols / window_s}

    def release(self) -> None:
        """Drop the program's state (its sampler and operand caches); the
        trapdoor and the public matrix stay, to be judged."""
        del self.sampler

    def judge(self, control: bool) -> dict:
        from mxx_tpu_torch.ring.poly import EVAL

        r, d = self.cfg["ring"], self.cfg["d"]
        ring = Ring(r["ring_dimension"], r["crt_depth"], r["crt_bits"], r["base_bits"], self.dev)

        def held(m):
            # the control holds every output of the program with one bit less
            return m.data & ~1 if control else m.data

        def evalform(m):
            return held(m) if m.fmt == EVAL else ring.fwd(held(m))

        def limb0_coeff(m):
            return ring._inv_limb(held(m)[0], 0) if m.fmt == EVAL else held(m)[0]

        sigma = self.cfg["trapdoor_sigma"]
        re_gap = max(judge.rms_gap(ring, limb0_coeff(m), sigma)
                     for m in (self.trapdoor.r, self.trapdoor.e))
        a_eval = evalform(self.public)
        rebuild = judge.rebuild_mismatch(ring, a_eval, evalform(self.trapdoor.r),
                                         evalform(self.trapdoor.e), d)
        totals = {"ax_mismatch": 0, "lift_mismatch": 0, "sum_sq": 0.0, "count": 0}
        kept = self.keeper.kept()
        for (i, fmt), (x_host,) in kept:
            x = x_host.to(self.dev)
            if control:
                x = x & ~1
            if fmt != EVAL:
                x = ring.fwd(x)
            u = self.target(i).data
            for key, value in judge.judge_answer(ring, a_eval, x, u).items():
                totals[key] += value
            del x
        s = judge.smoothing_s(ring, d, sigma)
        rms = (totals["sum_sq"] / max(totals["count"], 1)) ** 0.5 / s
        return {"answers_judged": len(kept), "a_rebuild_mismatch": rebuild,
                "re_rms_gap": re_gap, "ax_mismatch": totals["ax_mismatch"],
                "lift_mismatch": totals["lift_mismatch"], "x_rms_gap": abs(rms - 1.0)}


DRIVER = PreimageDriver
