"""What the benchmark runs imports neither JAX nor the JAX package, and
the plain reference imports nothing of the program. Module names are
compared by their top-level name, whole: ``codenerf_tpu_torch`` is the
port and passes, ``codenerf_tpu`` is the JAX package and fails."""

import ast
import os
import subprocess
import sys

from portbench.harness import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "codenerf_tpu"}
PORT = "codenerf_tpu_torch"


def _top_level_imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _files(*dirs, skip=("tests",)):
    for top in dirs:
        for d, subs, files in os.walk(top):
            subs[:] = [s for s in subs if s not in skip
                       and s != "__pycache__"]
            yield from (os.path.join(d, f) for f in files
                        if f.endswith(".py"))


def test_no_jax_in_what_runs():
    roots = [manifest.BENCH, os.path.join(manifest.ROOT, PORT)]
    bad = {p: sorted(_top_level_imports(p) & FORBIDDEN)
           for p in _files(*roots)}
    assert not {p: v for p, v in bad.items() if v}


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(manifest.BENCH, "reference")
    for p in _files(ref):
        names = _top_level_imports(p)
        assert PORT not in names and not names & FORBIDDEN, p
        # within the benchmark, only the reference itself
        for node in ast.walk(ast.parse(open(p).read())):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("portbench"):
                assert node.module.startswith("portbench.reference"), p


def test_loaded_modules_after_importing_every_kind():
    code = (
        "import sys, importlib, glob, os\n"
        f"sys.path.insert(0, {manifest.ROOT!r})\n"
        "from portbench.harness import manifest, runner\n"
        "for f in glob.glob(os.path.join(manifest.BENCH, 'kinds', "
        "'*.py')):\n"
        "    importlib.import_module('portbench.kinds.' + "
        "os.path.basename(f)[:-3])\n"
        "for m in manifest.load()['per_layer']:\n"
        "    manifest.load_reader(m['name'])\n"
        "import portbench.reference.train, portbench.reference.render\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    loaded = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert PORT in loaded
    assert not loaded & FORBIDDEN


def test_reference_alone_loads_no_program():
    code = (f"import sys; sys.path.insert(0, {manifest.ROOT!r})\n"
            "import portbench.reference.train, portbench.reference.render\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    loaded = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert PORT not in loaded and not loaded & FORBIDDEN
