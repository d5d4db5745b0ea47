"""Goldreich local PRG over FHE ciphertexts (predicate TSA = XOR3 (+) AND2).

A copy of `mxx_tpu/gadgets/fhe_prg/goldreich.py`, after the reference's src/gadgets/fhe_prg/goldreich.rs: output bit
y_i = x[a] ^ x[b] ^ x[c] ^ (x[d] & x[e]) with a deterministic seeded graph,
duplicate edges rejected by a role-aware key (sorted XOR triple + sorted AND
pair; optional strict same-vertex-set rejection). Evaluation composes the
ciphertext type's xor/and ops with balanced XOR nesting (goldreich.rs:20-24).

The CBD variant (`GoldreichFheCbdPrg`) aggregates PRG bits into centered-
binomial noise samples (goldreich.rs:1047+), used as noise material by the
noise-refresh pipeline.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass, field


def goldreich_output_bound_holds(input_size: int, output_size: int) -> bool:
    """Locality-5 PRG security heuristic: m <= n^1.5 (goldreich.rs:134)."""
    return output_size <= int(input_size**1.5)


def minimum_goldreich_input_size(output_size: int) -> int:
    n = max(5, math.ceil(output_size ** (2 / 3)))
    while not goldreich_output_bound_holds(n, output_size):
        n += 1
    return n


class _GraphSeedStream:
    """Deterministic u64 stream from a 32-byte seed (counter-mode SHA-256)."""

    def __init__(self, seed: bytes):
        self.seed = seed
        self.counter = 0
        self.buf = b""

    def next_u64(self) -> int:
        if len(self.buf) < 8:
            self.buf += hashlib.sha256(
                self.seed + self.counter.to_bytes(8, "little")
            ).digest()
            self.counter += 1
        v = int.from_bytes(self.buf[:8], "little")
        self.buf = self.buf[8:]
        return v

    def next_index(self, bound: int) -> int:
        # rejection sampling for unbiased indices
        mask_bits = max(1, bound - 1).bit_length()
        mask = (1 << mask_bits) - 1
        while True:
            v = self.next_u64() & mask
            if v < bound:
                return v


@dataclass(frozen=True)
class GoldreichEdge:
    xor_inputs: tuple[int, int, int]
    and_inputs: tuple[int, int]

    def __post_init__(self):
        all_in = self.all_inputs()
        assert len(set(all_in)) == 5, (
            "Goldreich edge inputs must be pairwise distinct across XOR and AND roles"
        )

    def all_inputs(self) -> tuple[int, ...]:
        return self.xor_inputs + self.and_inputs

    def role_aware_key(self):
        return (tuple(sorted(self.xor_inputs)), tuple(sorted(self.and_inputs)))

    def same_vertex_set_key(self):
        return tuple(sorted(self.all_inputs()))


def _derive_range_seed(graph_seed: bytes, conceptual: int, start: int, end: int) -> bytes:
    return hashlib.sha256(
        b"goldreich_range" + graph_seed
        + conceptual.to_bytes(8, "little")
        + start.to_bytes(8, "little")
        + end.to_bytes(8, "little")
    ).digest()


def _sample_next_unique_edge(input_size, stream, seen_keys, seen_vertex_sets):
    while True:
        idxs = []
        while len(idxs) < 5:
            c = stream.next_index(input_size)
            if c not in idxs:
                idxs.append(c)
        edge = GoldreichEdge(tuple(idxs[:3]), tuple(idxs[3:]))
        key = edge.role_aware_key()
        if key in seen_keys:
            continue
        if seen_vertex_sets is not None and edge.same_vertex_set_key() in seen_vertex_sets:
            continue
        seen_keys.add(key)
        if seen_vertex_sets is not None:
            seen_vertex_sets.add(edge.same_vertex_set_key())
        return edge


@dataclass
class GoldreichGraph:
    input_size: int
    edges: list[GoldreichEdge]
    graph_seed: bytes | None = None
    reject_same_vertex_set: bool = False

    @staticmethod
    def generate(
        input_size: int,
        output_size: int,
        graph_seed: bytes,
        reject_same_vertex_set: bool = False,
    ) -> "GoldreichGraph":
        assert input_size >= 5
        assert goldreich_output_bound_holds(input_size, output_size), (
            f"output {output_size} exceeds n^1.5 bound for input {input_size}"
        )
        seed = _derive_range_seed(graph_seed, output_size, 0, output_size)
        stream = _GraphSeedStream(seed)
        seen_keys: set = set()
        seen_sets = set() if reject_same_vertex_set else None
        edges = [
            _sample_next_unique_edge(input_size, stream, seen_keys, seen_sets)
            for _ in range(output_size)
        ]
        return GoldreichGraph(input_size, edges, graph_seed, reject_same_vertex_set)

    @staticmethod
    def generate_range(
        input_size: int,
        conceptual_output_size: int,
        range_start: int,
        range_len: int,
        graph_seed: bytes,
        reject_same_vertex_set: bool = False,
    ) -> "GoldreichGraph":
        """Edges [range_start, range_start+range_len) of the full-domain graph
        — bit-identical to slicing the full generation (goldreich.rs:294)."""
        seed = _derive_range_seed(
            graph_seed, conceptual_output_size, 0, conceptual_output_size
        )
        stream = _GraphSeedStream(seed)
        seen_keys: set = set()
        seen_sets = set() if reject_same_vertex_set else None
        for _ in range(range_start):
            _sample_next_unique_edge(input_size, stream, seen_keys, seen_sets)
        edges = [
            _sample_next_unique_edge(input_size, stream, seen_keys, seen_sets)
            for _ in range(range_len)
        ]
        return GoldreichGraph(input_size, edges, graph_seed, reject_same_vertex_set)

    @property
    def output_size(self) -> int:
        return len(self.edges)


class GoldreichFhePrg:
    """Evaluate the PRG over any ciphertext type exposing xor/and_ (e.g.
    RingGswCiphertext) or over plain ints via `evaluate_uniform`."""

    def __init__(self, graph: GoldreichGraph):
        self.graph = graph

    @staticmethod
    def setup(input_size: int, output_size: int, graph_seed: bytes,
              reject_same_vertex_set: bool = False) -> "GoldreichFhePrg":
        return GoldreichFhePrg(
            GoldreichGraph.generate(input_size, output_size, graph_seed, reject_same_vertex_set)
        )

    @staticmethod
    def setup_range(input_size: int, conceptual_output_size: int, range_start: int,
                    range_len: int, graph_seed: bytes) -> "GoldreichFhePrg":
        return GoldreichFhePrg(
            GoldreichGraph.generate_range(
                input_size, conceptual_output_size, range_start, range_len, graph_seed
            )
        )

    def _eval_edge(self, edge: GoldreichEdge, seed_cts, circuit):
        a, b, c = (seed_cts[i] for i in edge.xor_inputs)
        d, e = (seed_cts[i] for i in edge.and_inputs)
        t_and = d.and_(e, circuit)
        # balanced XOR composition (goldreich.rs:24)
        left = a.xor(b, circuit)
        right = c.xor(t_and, circuit)
        return left.xor(right, circuit)

    def evaluate(self, seed_cts: list, circuit) -> list:
        assert len(seed_cts) == self.graph.input_size
        return [self._eval_edge(e, seed_cts, circuit) for e in self.graph.edges]

    def evaluate_uniform(self, seed_bits: list[int]) -> list[int]:
        """Ground-truth plaintext evaluation (goldreich.rs:882)."""
        assert len(seed_bits) == self.graph.input_size
        out = []
        for e in self.graph.edges:
            a, b, c = (seed_bits[i] for i in e.xor_inputs)
            d, f = (seed_bits[i] for i in e.and_inputs)
            out.append(a ^ b ^ c ^ (d & f))
        return out


class GoldreichFheCbdPrg:
    """Centered-binomial noise from PRG bits: sample = sum_{i<eta} b_i -
    sum_{i<eta} b_{eta+i}, one group of 2*eta PRG outputs per noise sample
    (goldreich.rs:1047+)."""

    def __init__(self, input_size: int, num_samples: int, eta: int, graph_seed: bytes):
        self.eta = eta
        self.num_samples = num_samples
        self.prg = GoldreichFhePrg.setup(
            input_size, num_samples * 2 * eta, graph_seed
        )

    def evaluate_uniform(self, seed_bits: list[int]) -> list[int]:
        bits = self.prg.evaluate_uniform(seed_bits)
        out = []
        for s in range(self.num_samples):
            base = s * 2 * self.eta
            pos = sum(bits[base : base + self.eta])
            neg = sum(bits[base + self.eta : base + 2 * self.eta])
            out.append(pos - neg)
        return out

    def evaluate(self, seed_cts: list, circuit) -> list:
        """Ciphertext-domain CBD: returns per-sample lists of (positive bits,
        negative bits) ciphertexts; the caller combines them with its
        add/sub ops (ciphertext types differ in how they embed integers)."""
        bits = self.prg.evaluate(seed_cts, circuit)
        groups = []
        for s in range(self.num_samples):
            base = s * 2 * self.eta
            groups.append(
                (bits[base : base + self.eta], bits[base + self.eta : base + 2 * self.eta])
            )
        return groups
