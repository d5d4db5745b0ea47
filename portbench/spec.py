"""The benchmark's files, found by name and checked against their schemas.

`BENCHMARK.json` names configurations, traffic mixes and cells; each has a
file of its own under `portbench/`:

- `configs/<config>.json`: the deployment, its source, `reduced`, `assumed`,
  and the keys that the drivers of its cells read (the ring, d, sigmas);
- `traffic/<mix>.json`: the parameters that one general driver reads;
- `drivers/<driver>.py`: that driver, the class `DRIVER`, whose
  `MIX_SCHEMA` and `CONFIG_SCHEMA` are the closed fragments of the keys it
  reads from a mix and from a configuration;
- `cells/<cell>.json`: the limits of what the cell compares, and what was
  counted once for it (its transforms);
- `metrics/<metric>.py`: the reader of one per-layer metric; a metric
  `<quantity>.<qualifier>` with no file of its own is read by the file of
  its longest dotted prefix that has one, so that one quantity can be split
  by the cells that report it.

A later change adds a configuration, a mix, a driver, a cell or a metric by
adding such files and entries. `Spec` looks each name up in its search
directories in order, so a test can add dummies from a directory of its own.

A mix is checked against `schema/traffic.schema.json` (the keys every mix
shares) together with its driver's `MIX_SCHEMA`, and a configuration against
`schema/config.schema.json` together with the `CONFIG_SCHEMA` of every driver
that runs a cell of it: a key that none of them names is refused.

The schemas are a small subset of JSON Schema (type, required, properties,
additionalProperties, enum, items, minimum, maximum, pattern), checked here
because the card's machine has no `jsonschema` package.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
SCHEMAS = HERE / "schema"
TYPES = {"object": dict, "array": list, "string": str, "integer": int, "number": (int, float),
         "boolean": bool}


class SpecError(ValueError):
    """A benchmark file that breaks its schema or names what does not exist."""


def validate(value, schema: dict, where: str) -> None:
    """Raise SpecError where `value` breaks `schema`."""
    kind = schema.get("type")
    if kind is not None:
        ok = isinstance(value, TYPES[kind]) and not (kind in ("integer", "number")
                                                     and isinstance(value, bool))
        if not ok:
            raise SpecError(f"{where}: expected {kind}, got {type(value).__name__}")
    if "enum" in schema and value not in schema["enum"]:
        raise SpecError(f"{where}: {value!r} is not one of {schema['enum']}")
    if "minimum" in schema and value < schema["minimum"]:
        raise SpecError(f"{where}: {value} < {schema['minimum']}")
    if "maximum" in schema and value > schema["maximum"]:
        raise SpecError(f"{where}: {value} > {schema['maximum']}")
    if "pattern" in schema and not re.fullmatch(schema["pattern"], value):
        raise SpecError(f"{where}: {value!r} does not match {schema['pattern']}")
    if isinstance(value, dict):
        for key in schema.get("required", ()):
            if key not in value:
                raise SpecError(f"{where}: missing key {key!r}")
        props = schema.get("properties", {})
        for key, item in value.items():
            if key in props:
                validate(item, props[key], f"{where}.{key}")
            elif schema.get("additionalProperties", True) is False:
                raise SpecError(f"{where}: unknown key {key!r}")
    if isinstance(value, list) and "items" in schema:
        for i, item in enumerate(value):
            validate(item, schema["items"], f"{where}[{i}]")


def dotted_prefixes(name: str) -> list[str]:
    """`name` and its shorter dotted prefixes, longest first. A metric
    `<quantity>.<qualifier>` falls back to what `<quantity>` has (the
    driver's value, the reader's file), so that one quantity can be split by
    the cells that get a bound of their own."""
    parts = name.split(".")
    return [".".join(parts[:end]) for end in range(len(parts), 0, -1)]


def load_json(path: Path, schema_name: str, fragments: tuple[dict, ...] = ()) -> dict:
    """The file, checked against the schema and the drivers' `fragments`:
    the schema is closed over its own keys and theirs, and each fragment
    checks its own keys and names those it requires (a key that two of them
    define meets both)."""
    data = json.loads(path.read_text())
    schema = json.loads((SCHEMAS / f"{schema_name}.schema.json").read_text())
    # the fragments' keys are let through here and checked by their fragments
    wider = {key: {} for frag in fragments for key in frag["properties"]}
    validate(data, dict(schema, properties={**wider, **schema["properties"]}), path.name)
    for frag in fragments:
        validate(data, dict(frag, type="object"), path.name)
    return data


class Spec:
    """`BENCHMARK.json` and the files its names lead to."""

    def __init__(self, bench_file: Path, search_dirs: list[Path] | None = None):
        self.bench_file = Path(bench_file)
        self.root = self.bench_file.parent
        self.bench = load_json(self.bench_file, "benchmark")
        self.search_dirs = [Path(d) for d in (search_dirs or [])] + [HERE]
        self.configs = {c["name"]: c for c in self.bench["configs"]}
        self.cells = {w["name"]: w for w in self.bench["workloads"]}
        for cell in self.cells.values():
            if cell["config"] not in self.configs:
                raise SpecError(f"cell {cell['name']} names unknown config {cell['config']}")

    def _find(self, sub: str, filename: str) -> Path | None:
        for d in self.search_dirs:
            path = d / sub / filename
            if path.is_file():
                return path
        return None

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise SpecError(f"no cell {name!r} in {self.bench_file.name}")
        return self.cells[name]

    def config(self, name: str) -> dict:
        """The configuration, checked with the fragments of the drivers of
        its cells."""
        entry = self.configs[name]
        drivers = {self.traffic(c["traffic"])["driver"] for c in self.cells.values()
                   if c["config"] == name}
        data = load_json(self.root / entry["file"], "config",
                         tuple(self.driver(d).CONFIG_SCHEMA for d in sorted(drivers)))
        if data["name"] != name:
            raise SpecError(f"{entry['file']} holds config {data['name']!r}, not {name!r}")
        return data

    def traffic(self, name: str) -> dict:
        path = self._find("traffic", f"{name}.json")
        if path is None:
            raise SpecError(f"no traffic file for mix {name!r}")
        driver = json.loads(path.read_text()).get("driver")
        # a missing or malformed `driver` is refused by the shared schema
        fragments = (self.driver(driver).MIX_SCHEMA,) if isinstance(driver, str) else ()
        data = load_json(path, "traffic", fragments)
        if data["name"] != name:
            raise SpecError(f"{path.name} holds mix {data['name']!r}, not {name!r}")
        return data

    def cell_counts(self, name: str) -> dict:
        """The cell's own file: its limits and its frozen transform counts."""
        path = self._find("cells", f"{name}.json")
        if path is None:
            raise SpecError(f"no cells/{name}.json with the cell's limits")
        return load_json(path, "cell")

    def end_to_end(self, cell: str) -> list[dict]:
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> list[dict]:
        return [m for m in self.bench["per_layer"]
                if "workloads" not in m or cell in m["workloads"]]

    def driver(self, name: str):
        """The class `DRIVER` of `drivers/<name>.py`. The file is loaded as
        the module `portbench.drivers.<name>`, so that it may import the
        package's own modules relatively, from whichever search directory
        it lies in."""
        if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]{0,63}", name):
            raise SpecError(f"{name!r} is not a driver's name")
        path = self._find("drivers", f"{name}.py")
        if path is None:
            raise SpecError(f"no driver drivers/{name}.py")
        mod_name = f"portbench.drivers.{name}"
        module = sys.modules.get(mod_name)
        if module is None or Path(module.__file__).resolve() != path.resolve():
            spec = importlib.util.spec_from_file_location(mod_name, path)
            module = importlib.util.module_from_spec(spec)
            sys.modules[mod_name] = module
            spec.loader.exec_module(module)
        if not hasattr(module, "DRIVER"):
            raise SpecError(f"drivers/{name}.py has no DRIVER")
        return module.DRIVER

    def reader(self, metric: str):
        """The `read(trace)` function of `metrics/<prefix>.py`, for the
        longest dotted prefix of `metric` that has a file."""
        path = next(filter(None, (self._find("metrics", f"{p}.py")
                                  for p in dotted_prefixes(metric))), None)
        if path is None:
            raise SpecError(f"no reader metrics/{metric}.py, nor of a prefix of it")
        mod_name = "portbench_metric_" + re.sub(r"\W", "_", metric)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
