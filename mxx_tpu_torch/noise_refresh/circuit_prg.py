"""Goldreich PRG material generation for the noise-refresh protocol.

A copy of `mxx_tpu/noise_refresh/circuit_prg.py`, after the reference's src/noise_refresh/circuit_prg.rs: expands
encrypted seed bits into encrypted PRG material — CBD `errors` first, then
uniform `masks` — without decrypting or combining (those phases live in
circuit_decrypt / circuit_merge). Each logical ciphertext flattens at the
PolyCircuit boundary only.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..gadgets.fhe_prg.goldreich import GoldreichFheCbdPrg, GoldreichFhePrg


@dataclass(frozen=True)
class GoldreichNoiseRefreshOutputSizes:
    """Logical ciphertext counts (circuit_prg.rs:29-83)."""

    mask_bits: int
    cbd_values: int

    @property
    def total(self) -> int:
        return self.mask_bits + self.cbd_values


def goldreich_noise_refresh_output_sizes(ring_dim: int, log_base_q: int,
                                         crt_depth: int, v_bits: int
                                         ) -> GoldreichNoiseRefreshOutputSizes:
    """Refresh material for one encoding wire: `log_base_q * ring_dim`
    coefficient CBD errors and `crt_depth * log_base_q * ring_dim * v_bits`
    mask bits (circuit_prg.rs:60-83)."""
    assert ring_dim > 0 and log_base_q > 0 and crt_depth > 0 and v_bits > 0
    cbd_values = log_base_q * ring_dim
    mask_bits = cbd_values * v_bits * crt_depth
    return GoldreichNoiseRefreshOutputSizes(mask_bits, cbd_values)


def goldreich_noise_refresh_uniform_output_bits(ring_dim: int, log_base_q: int,
                                                crt_depth: int, v_bits: int,
                                                cbd_n: int) -> int:
    """Total uniform Goldreich bits drawn from one encrypted seed: CBD values
    use 2*cbd_n streams each; mask bits one each (circuit_prg.rs:86+)."""
    sizes = goldreich_noise_refresh_output_sizes(ring_dim, log_base_q, crt_depth, v_bits)
    return sizes.cbd_values * 2 * cbd_n + sizes.mask_bits


def derive_noise_refresh_graph_seed(graph_seed: bytes, label: bytes, idx: int) -> bytes:
    """Domain-separated per-stream graph seed (circuit_prg.rs helper)."""
    return hashlib.sha256(
        graph_seed + b"|" + label + b"|" + idx.to_bytes(8, "little")
    ).digest()


@dataclass
class GoldreichNoiseRefreshMaterial:
    """Encrypted refresh material: CBD error ciphertexts then mask-bit
    ciphertexts (circuit_prg.rs:40-48)."""

    errors: list
    masks: list


def build_ranged_prg_material_digit(circuit, seed_cts: list, graph_seed: bytes,
                                    digit_idx: int, ring_dim: int, log_base_q: int,
                                    crt_depth: int, v_bits: int, cbd_n: int):
    """One gadget digit's refresh material from range slices of the CONCEPTUAL
    full-domain Goldreich streams (reference
    build_goldreich_encrypted_seed_material_ranges, naive_vec.rs:1883-1914:
    error range = digit_idx*ring_dim samples of the CBD stream; mask ranges
    = crt_idx*log_base_q*chunk + digit_idx*chunk with chunk = ring_dim*v_bits).

    Returns (errors, masks_by_crt): `errors` = ring_dim CBD-combined value
    ciphertexts; `masks_by_crt[crt]` = ring_dim*v_bits bit ciphertexts. All
    in-circuit over the encrypted seed — no host randomness."""
    input_size = len(seed_cts)
    # CBD stream: log_base_q * ring_dim samples, 2*cbd_n bits each
    bits_per_digit = ring_dim * 2 * cbd_n
    cbd_prg = GoldreichFhePrg.setup_range(
        input_size, log_base_q * bits_per_digit,
        digit_idx * bits_per_digit, bits_per_digit,
        derive_noise_refresh_graph_seed(graph_seed, b"NoiseRefreshCBD/v1", 0),
    )
    bits = cbd_prg.evaluate(seed_cts, circuit)
    errors = []
    for i in range(ring_dim):
        base = i * 2 * cbd_n
        acc = bits[base]
        for j in range(1, cbd_n):
            acc = acc.add(bits[base + j], circuit)
        for j in range(cbd_n):
            acc = acc.sub(bits[base + cbd_n + j], circuit)
        errors.append(acc)
    # mask stream: crt_depth * log_base_q * chunk bits, chunk = ring_dim*v
    chunk = ring_dim * v_bits
    mask_seed = derive_noise_refresh_graph_seed(graph_seed, b"NoiseRefreshMask/v1", 0)
    masks_by_crt = []
    for crt_idx in range(crt_depth):
        start = crt_idx * log_base_q * chunk + digit_idx * chunk
        prg = GoldreichFhePrg.setup_range(
            input_size, crt_depth * log_base_q * chunk, start, chunk, mask_seed
        )
        masks_by_crt.append(prg.evaluate(seed_cts, circuit))
    return errors, masks_by_crt


def build_noise_refresh_prg_material(circuit, seed_cts: list, graph_seed: bytes,
                                     ring_dim: int, log_base_q: int, crt_depth: int,
                                     v_bits: int, cbd_n: int
                                     ) -> GoldreichNoiseRefreshMaterial:
    """Expand encrypted seed bits into the full refresh material in-circuit.

    `seed_cts` are RingGSW bit ciphertexts. CBD errors use
    `GoldreichFheCbdPrg` (eta = cbd_n); mask bits use one uniform
    `GoldreichFhePrg` stream. WARNING: each output bit costs Goldreich-degree
    many homomorphic GSW ops — only tiny configurations are tractable outside
    production hardware (the reference carries the same caveat)."""
    sizes = goldreich_noise_refresh_output_sizes(ring_dim, log_base_q, crt_depth, v_bits)
    input_size = len(seed_cts)
    cbd = GoldreichFheCbdPrg(
        input_size, sizes.cbd_values, cbd_n,
        derive_noise_refresh_graph_seed(graph_seed, b"NoiseRefreshCBD/v1", 0),
    )
    errors = cbd.evaluate(seed_cts, circuit)
    mask_prg = GoldreichFhePrg.setup(
        input_size, sizes.mask_bits,
        derive_noise_refresh_graph_seed(graph_seed, b"NoiseRefreshMask/v1", 0),
    )
    masks = mask_prg.evaluate(seed_cts, circuit)
    return GoldreichNoiseRefreshMaterial(errors=errors, masks=masks)
