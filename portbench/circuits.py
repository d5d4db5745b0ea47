"""The BGG+ circuit of the online pass, as plain data.

A frozen copy of chip_smoke.py's `bgg_circuit`: 16 public and 16 secret
inputs; public input i scaled by the small scalar i + 1 (i < 8) or the large
scalar 2^20 + i (i >= 8); the inner product of the scaled public inputs with
the secret ones (`gadgets/secret_ip.py`: public operand on the left, the
products summed from the first); and four differences scaled[j] -
scaled[j + 4]. 51 gates.

Wire 0 is the constant one, wires 1..inputs the inputs in order, and each
gate's output wire is the next number. The harness builds the program's
circuit from this list and the reference evaluates the same list.
"""

from __future__ import annotations


def online_pass(n_in: int = 16) -> dict:
    gates = []

    def gate(op, args, scalar=None):
        gates.append({"op": op, "in": list(args), "scalar": scalar})
        return 2 * n_in + len(gates)

    pub = list(range(1, n_in + 1))
    sec = list(range(n_in + 1, 2 * n_in + 1))
    scaled = [gate("small", [pub[i]], [i + 1]) for i in range(8)]
    scaled += [gate("large", [pub[i]], [2**20 + i]) for i in range(8, n_in)]
    acc = gate("mul", [scaled[0], sec[0]])
    for p, s in zip(scaled[1:], sec[1:]):
        acc = gate("add", [acc, gate("mul", [p, s])])
    outputs = [acc] + [gate("sub", [scaled[j], scaled[j + 4]]) for j in range(4)]
    return {"inputs": 2 * n_in, "reveal": [True] * n_in + [False] * n_in, "gates": gates,
            "outputs": outputs}


def to_program(spec: dict):
    """The program's `PolyCircuit` of the plain circuit."""
    from mxx_tpu_torch.circuit import PolyCircuit

    c = PolyCircuit()
    wires = c.input(spec["inputs"])
    ids = [0] + list(range(wires.start, wires.start + wires.count))
    for g in spec["gates"]:
        a = [ids[i] for i in g["in"]]
        if g["op"] == "small":
            ids.append(c.small_scalar_mul(a[0], g["scalar"]))
        elif g["op"] == "large":
            ids.append(c.large_scalar_mul(a[0], g["scalar"]))
        elif g["op"] == "mul":
            ids.append(c.mul_gate(a[0], a[1]))
        elif g["op"] == "add":
            ids.append(c.add_gate(a[0], a[1]))
        elif g["op"] == "sub":
            ids.append(c.sub_gate(a[0], a[1]))
        else:
            raise ValueError(f"unknown gate {g['op']}")
    c.output([ids[i] for i in spec["outputs"]])
    return c
