"""Closed loop of BGG+ circuit passes over encodings (the online phase).

Set-up makes, from the run's seed and with the benchmark's own arithmetic,
the public matrices A_w of the circuit's input wires (uniform, shared by
every pass) and a pool of `input_sets` encodings of every wire, each set
under a secret s of its own, with plaintexts x_w and errors e_w:
c_w = s A_w - x_w (s G) + e_w. They are handed to the program as
`BggPublicKey` and `BggEncoding` wires, and one pass is warmed up. Pass i
draws each wire's encoding from its pool by a hash of the seed, i and the
wire, so no two passes of a window share their inputs (as online traffic
brings a fresh ciphertext to each), evaluates the circuit of
`circuits.online_pass` through `circuit.batched_eval.eval_batched`, and ends
in a synchronise: its time is host clock.
"""

from __future__ import annotations

import time

import torch

from .. import circuits
from ..reference import bgg as ref
from ..reference.ring import Ring
from .common import RING_SCHEMA, Keeper, generator, sub_seed, uniform_residues


class BggPassDriver:
    MIX_SCHEMA = {
        "required": ["input_sets"],
        "properties": {"input_sets": {"type": "integer", "minimum": 2}},
    }
    CONFIG_SCHEMA = {
        "required": ["ring", "d", "encoding_error_sigma"],
        "properties": {
            "ring": RING_SCHEMA,
            "d": {"type": "integer", "minimum": 1},
            "encoding_error_sigma": {"type": "number", "minimum": 0},
        },
    }

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.mix = ctx.cfg, ctx.mix
        self.dev = ctx.device(0)
        self.spec = circuits.online_pass()
        self.pass_s: list[float] = []

    def _pool(self, ring: Ring):
        """(public matrices [L, 1, k, n] per wire, pool of sets of
        (c [L, 1, k, n], x EVAL [L, n]) per wire) made from the seed."""
        n, k, seed = ring.n, ring.k, self.ctx.seed
        sigma = self.cfg["encoding_error_sigma"]
        count = self.spec["inputs"] + 1
        g = generator(self.dev, sub_seed(seed, "public"))
        pubs = uniform_residues(ring.q, (count, k, n), g)
        pool = []
        for j in range(self.mix["input_sets"]):
            g = generator(self.dev, sub_seed(seed, "set", j))

            def ternary(shape):
                return torch.randint(-1, 2, shape, generator=g, dtype=torch.int64,
                                     device=self.dev)

            s = ring.fwd(ring.from_signed(ternary((n,))))
            x = ring.from_signed(ternary((count, n)))
            x[:, 0] = ring.from_ints([1])  # wire 0 is the constant one
            e = torch.round(torch.randn((count, k, n), generator=g, dtype=torch.float64,
                                        device=self.dev) * sigma)
            c = ref.make_encoding(ring, s, pubs, x, ring.from_signed(e))
            x = ring.fwd(x)
            pool.append([(c[:, w:w + 1].contiguous(), x[:, w].contiguous())
                         for w in range(count)])
            del c, x, e
        return [pubs[:, w:w + 1].contiguous() for w in range(count)], pool

    def draw(self, i: int) -> list[int]:
        """The pool set of each input wire in pass i."""
        return [sub_seed(self.ctx.seed, "draw", i, w) % len(self.pool)
                for w in range(self.spec["inputs"] + 1)]

    def setup(self) -> None:
        from mxx_tpu_torch.bgg import BggEncoding, BggPublicKey
        from mxx_tpu_torch.matrix import PolyMatrix
        from mxx_tpu_torch.ring.params import RingParams
        from mxx_tpu_torch.ring.poly import EVAL, Poly

        r = self.cfg["ring"]
        if self.cfg["d"] != 1:
            raise ValueError("the online pass is built for d = 1")
        self.ring = Ring(r["ring_dimension"], r["crt_depth"], r["crt_bits"], r["base_bits"],
                         self.dev)
        self.params = RingParams.new(r["ring_dimension"], r["crt_depth"], r["crt_bits"],
                                     r["base_bits"])
        t0 = time.perf_counter()
        self.pubs, self.pool = self._pool(self.ring)
        self.ctx.sync()
        t1 = time.perf_counter()
        self.circuit = circuits.to_program(self.spec)
        reveal = [True] + self.spec["reveal"]
        pks = [BggPublicKey(PolyMatrix(a, EVAL, self.params), rv)
               for a, rv in zip(self.pubs, reveal)]
        self.wire_pool = [[BggEncoding(PolyMatrix(c, EVAL, self.params), pk,
                                       Poly(x, EVAL, self.params) if pk.reveal_plaintext
                                       else None)
                           for (c, x), pk in zip(wires, pks)] for wires in self.pool]
        for i in range(self.mix.get("warmup", 1)):
            outs = self.request(-1 - i)
        self.pass_s.clear()
        t2 = time.perf_counter()
        self.keeper = Keeper(self.dev, self.mix["keep_every"], self.mix["keep_slots"],
                             sub_seed(self.ctx.seed, "keep") % self.mix["keep_every"])
        self.keeper.allocate(self._tensors(outs))
        self.setup_split_s = {"inputs": t1 - t0, "warmup": t2 - t1,
                              "pinned_buffers": time.perf_counter() - t2}
        self.formats = [(o.vector.fmt, o.pubkey.matrix.fmt,
                         None if o.plaintext is None else o.plaintext.fmt) for o in outs]
        self.held_bytes = None

    @staticmethod
    def _tensors(outs) -> list[torch.Tensor]:
        out = []
        for o in outs:
            out += [o.vector.data, o.pubkey.matrix.data]
            if o.plaintext is not None:
                out.append(o.plaintext.data)
        return out

    def request(self, i: int):
        from mxx_tpu_torch.circuit.batched_eval import eval_batched

        encs = [self.wire_pool[j][w] for w, j in enumerate(self.draw(i))]
        t0 = time.perf_counter()
        outs = eval_batched(self.circuit, self.params, encs[0], encs[1:])
        self.ctx.sync()
        self.pass_s.append(time.perf_counter() - t0)
        return outs

    def keep(self, i: int, outs, force: bool = False) -> None:
        if self.keeper.wants(i) or force:  # wanted ones are kept in the window
            self.keeper.keep(i, self._tensors(outs))

    def end_to_end(self, window_s: float, done: int) -> dict:
        s = sorted(self.pass_s)
        return {"bgg_gates_per_s": done * len(self.spec["gates"]) / window_s,
                "bgg_pass_p95_ms": s[max(0, -(-95 * len(s) // 100) - 1)] * 1e3}

    def release(self) -> None:
        """Drop the program's wires and circuit."""
        del self.wire_pool, self.circuit

    def judge(self, control: bool) -> dict:
        from mxx_tpu_torch.ring.poly import EVAL

        ring = self.ring
        mismatch = 0
        cache: dict = {}
        kept = self.keeper.kept()
        for i, host in kept:
            wires = [self.pool[j][w] for w, j in enumerate(self.draw(i))]
            inputs = [(a, c, x if rv else None) for a, (c, x), rv in
                      zip(self.pubs, wires, [True] + self.spec["reveal"])]
            expect = ref.evaluate(ring, self.spec, inputs, cache)
            got = iter(t.to(self.dev) for t in host)
            for (a, c, x), (cf, af, xf) in zip(expect, self.formats):
                pairs = [(c, cf), (a, af)] + ([(x, xf)] if xf is not None else [])
                for want, fmt in pairs:
                    t = next(got)
                    if want is None:  # a plaintext the reference cannot know
                        mismatch += 1
                        continue
                    if control:
                        t = t & ~1
                    if fmt != EVAL:
                        t = ring.fwd(t)
                    mismatch += int((t.reshape(want.shape) != want).sum())
                if x is not None and xf is None:
                    mismatch += 1
        return {"answers_judged": len(kept), "output_mismatch": mismatch}


DRIVER = BggPassDriver
