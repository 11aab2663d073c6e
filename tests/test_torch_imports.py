"""Import hygiene of the PyTorch port: importing every one of its modules
in a fresh interpreter loads neither jax nor the JAX package, and
chip_smoke.py imports neither and refuses to run without a CUDA device."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401  (one intra-op thread per test process)

ROOT = Path(__file__).resolve().parent.parent

PROBE = """
import importlib, pkgutil, sys
import distributed_llm_inference_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "distributed_llm_inference_tpu"
             or m.startswith("distributed_llm_inference_tpu."))
print(len(names), bad)
sys.exit(1 if bad or len(names) < 15 else 0)
"""


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "distributed_llm_inference_tpu")


def test_port_never_imports_jax():
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_constrain_imports_nothing_of_jax():
    """constrain/ (copied from the JAX package, its tables uploaded with
    torch): each module imports neither jax nor the JAX package, and the
    package compiles and uploads a constraint without loading either."""
    names = sorted(p.stem for p in
                   (ROOT / "distributed_llm_inference_tpu_torch" / "constrain").glob("*.py"))
    assert names == ["__init__", "fleet", "regex", "schema", "tables", "vocab"]
    for name in names:
        path = ROOT / "distributed_llm_inference_tpu_torch" / "constrain" / f"{name}.py"
        tree = ast.parse(path.read_text())
        imported = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                    for a in n.names]
        imported += [n.module for n in ast.walk(tree)
                     if isinstance(n, ast.ImportFrom) and n.module and n.level == 0]
        assert not [m for m in imported if _forbidden(m)], (name, imported)
    probe = (
        "import sys\n"
        "from distributed_llm_inference_tpu_torch import constrain as C\n"
        "from distributed_llm_inference_tpu_torch.utils.tokenizer import ByteTokenizer\n"
        "v = C.TokenVocab.from_tokenizer(ByteTokenizer(), 300, (2,), (0, 1))\n"
        "a = C.compile_constraint({'json_object': True}, v)\n"
        "a.device_tables('cpu')\n"
        "t = C.FleetConstraintTable(300, 64)\n"
        "t.acquire(a)\n"
        "t.device_tables('cpu')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'distributed_llm_inference_tpu')]\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _loads_alone_without_jax(module: str):
    """`module` (a path under the package) imports neither jax nor the JAX
    package by name, and loads alone in a fresh interpreter without
    pulling either in."""
    path = ROOT / "distributed_llm_inference_tpu_torch" / module
    tree = ast.parse(path.read_text())
    imported = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names]
    imported += [n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module and n.level == 0]
    assert not [m for m in imported if _forbidden(m)], (module, imported)
    name = "distributed_llm_inference_tpu_torch." + module[:-3].replace("/", ".")
    probe = (
        "import importlib, sys\n"
        f"importlib.import_module({name!r})\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'distributed_llm_inference_tpu')]\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("module", ["engine/prefix.py", "serving/queue.py"])
def test_solo_feature_modules_import_nothing_of_jax(module):
    """engine/prefix.py (written anew: the JAX one imports jax) and
    serving/queue.py (copied) import neither jax nor the JAX package, and
    each loads alone without pulling either in."""
    _loads_alone_without_jax(module)


@pytest.mark.parametrize("module", ["serving/stage_runtime.py", "parallel/schedule.py",
                                    "ops/wire_quant.py"])
def test_stage_pipeline_modules_import_nothing_of_jax(module):
    """The MPMD stage runtime (written anew on torch), the stage planning
    (copied from the JAX parallel/schedule.py) and the int8 wire format
    import neither jax nor the JAX package, and each loads alone."""
    _loads_alone_without_jax(module)


@pytest.mark.parametrize("module", ["parallel/mesh.py", "parallel/comm.py",
                                    "parallel/partition.py", "parallel/vocab.py",
                                    "parallel/pipeline.py", "serving/multihost.py",
                                    "models/checkpoint.py"])
def test_mesh_modules_import_nothing_of_jax(module):
    """The pipeline backend's modules (written anew on torch.distributed),
    the multi-process serving and the store's sharded loads import neither
    jax nor the JAX package, and each loads alone."""
    _loads_alone_without_jax(module)


@pytest.mark.parametrize("module", ["parallel/context.py", "parallel/ring.py",
                                    "parallel/schedule.py", "runtime.py"])
def test_part_b_mesh_modules_import_nothing_of_jax(module):
    """The 1F1B schedule, the context-parallel backend, its ring attention
    and the runtime that selects them (written anew on torch.distributed)
    import neither jax nor the JAX package, and each loads alone."""
    _loads_alone_without_jax(module)


def test_chip_smoke_imports_nothing_of_jax():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    imported = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names]
    imported += [n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module]
    assert "distributed_llm_inference_tpu_torch.runtime" in imported
    assert not [m for m in imported if _forbidden(m)], imported


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def _roadmap_items() -> dict:
    """Every ROADMAP.md item a not-ported error of the port names, by the
    module that names it: the literal `ROADMAP.md "<item>"` in a string,
    the item argument of each `_not_ported(what, item)` call (a string or
    a module-level string constant of the package), and the item each
    `not_ported(what)` of parallel/mesh.py names (the module constant its
    message interpolates)."""
    import re

    quoted = re.compile(r'ROADMAP\.md "([^"]+)"')
    trees = {path: ast.parse(path.read_text()) for path in
             sorted((ROOT / "distributed_llm_inference_tpu_torch").rglob("*.py"))}
    # module-level string constants of the whole package (an item name may
    # be imported from the module that defines it)
    consts = {t.id: n.value.value for tree in trees.values() for n in tree.body
              if isinstance(n, ast.Assign) and isinstance(n.value, ast.Constant)
              and isinstance(n.value.value, str) for t in n.targets
              if isinstance(t, ast.Name)}
    # parallel/mesh.not_ported's message: 'ROADMAP.md "{NAME}"' in an f-string
    # (none since "Multi-GPU SPMD" was ported whole)
    mesh_tree = trees[ROOT / "distributed_llm_inference_tpu_torch" / "parallel" / "mesh.py"]
    fn = next((n for n in mesh_tree.body
               if isinstance(n, ast.FunctionDef) and n.name == "not_ported"), None)
    mesh_item = None
    if fn is not None:
        interp = [v.value.id for n in ast.walk(fn) if isinstance(n, ast.JoinedStr)
                  for v in n.values if isinstance(v, ast.FormattedValue)
                  and isinstance(v.value, ast.Name) and v.value.id in consts]
        assert len(interp) == 1, interp
        mesh_item = consts[interp[0]]
    found = {}
    for path, tree in trees.items():
        items = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                items.update(quoted.findall(node.value))
            func = getattr(node, "func", None) if isinstance(node, ast.Call) else None
            if getattr(func, "id", getattr(func, "attr", "")) == "not_ported" \
                    or (isinstance(node, ast.FunctionDef) and node.name == "not_ported"):
                items.add(mesh_item)
            if (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "_not_ported"
                    and len(node.args) == 2):
                arg = node.args[1]
                if isinstance(arg, ast.Constant):
                    items.add(arg.value)
                elif isinstance(arg, ast.Name):
                    items.add(consts[arg.id])
        if items:
            found[path.relative_to(ROOT).as_posix()] = items
    return found


def test_not_ported_errors_name_roadmap_headings():
    """A not-ported error names its ROADMAP.md item by the item's heading,
    never by a number that goes stale when the queues are rewritten."""
    import re

    headings = {line.lstrip("#").strip() for line in
                (ROOT / "ROADMAP.md").read_text().splitlines() if line.startswith("#")}
    found = _roadmap_items()
    # the modules that still refuse something (the scanner finds them all):
    # none since part C of "Multi-GPU SPMD" ported adapters and two-model
    # speculation on a mesh, the sharded loads and the multi-host meshes
    assert sorted(found) == [], sorted(found)
    missing = {f: sorted(i - headings) for f, i in found.items() if i - headings}
    assert not missing, missing
    numbered = re.compile(r"ROADMAP[^\n]{0,40}\bitem \d")
    for path in (ROOT / "distributed_llm_inference_tpu_torch").rglob("*.py"):
        assert not numbered.search(path.read_text()), path


@pytest.mark.parametrize("flag", ["--sp 2", "--ep 2", "--sp-strategy ulysses",
                                  "--microbatches 2", "--coordinator 127.0.0.1:1",
                                  "--num-processes 2", "--process-id 0"])
def test_part_b_server_flags_name_the_roadmap_heading(flag, monkeypatch):
    """The JAX server's mesh flags: --sp, --ep, --sp-strategy and
    --microbatches reach create_engine as the JAX server passes them (part
    B of "Multi-GPU SPMD"); the multi-host ones (part C) reach
    multihost_initialize as the JAX server passes them, before any model
    is built."""
    from distributed_llm_inference_tpu_torch import runtime
    from distributed_llm_inference_tpu_torch.parallel import mesh as PM
    from distributed_llm_inference_tpu_torch.serving import server

    seen, hosts = {}, {}

    def fake_create_engine(model, **kw):
        seen.update(kw)
        raise SystemExit("built")

    def fake_initialize(**kw):
        hosts.update(kw)
        raise SystemExit("initialized")

    monkeypatch.setattr(runtime, "create_engine", fake_create_engine)
    monkeypatch.setattr(PM, "multihost_initialize", fake_initialize)
    with pytest.raises(SystemExit) as e:
        server.main(["--model", "test-llama-tiny", "--device", "cpu", *flag.split()])
    name, value = flag.split()
    if name in ("--coordinator", "--num-processes", "--process-id"):
        assert e.value.code == "initialized" and not seen
        key = {"--coordinator": "coordinator_address", "--num-processes": "num_processes",
               "--process-id": "process_id"}[name]
        assert str(hosts[key]) == value
        return
    assert e.value.code == "built"
    got = {"--sp": seen["mesh_cfg"].sp, "--ep": seen["mesh_cfg"].ep,
           "--sp-strategy": seen["sp_strategy"],
           "--microbatches": seen["microbatches"]}[name]
    assert str(got) == value


def test_named_headings_are_the_ones_roadmap_lists():
    """The headings the port's not-ported errors name are exactly the ones
    ROADMAP.md lists as named today: a message removed with the code it
    refused leaves no heading behind that nothing names, and no message
    names a heading the list dropped."""
    import re

    text = (ROOT / "ROADMAP.md").read_text()
    m = re.search(r"The headings named today:(.*?)\.\n", text, re.S)
    assert m, "ROADMAP.md lists no headings named today"
    listed = set(re.findall(r'"([^"]+)"', re.sub(r"\s+", " ", m.group(1))))
    named = set().union(*_roadmap_items().values())
    assert named == listed, (sorted(named), sorted(listed))


def test_not_ported_routes_are_routes_the_port_lacks():
    """The server answers no route with 501: every route of the JAX
    server's GET surface is served (the trace store's `/debug/traces`, the
    last one, since the fleet tier's router and traces were ported), and
    the OpenAI routes are known."""
    import json
    import urllib.error
    import urllib.request

    from distributed_llm_inference_tpu.serving import server as jax_server
    from distributed_llm_inference_tpu_torch.runtime import create_engine
    from distributed_llm_inference_tpu_torch.serving import server

    assert not hasattr(server, "_NOT_PORTED_ROUTES")
    assert "501" not in (ROOT / "distributed_llm_inference_tpu_torch" / "serving"
                         / "server.py").read_text()
    assert jax_server._KNOWN_ROUTES <= server._KNOWN_ROUTES
    assert {"/v1/models", "/v1/completions",
            "/v1/chat/completions"} <= server._KNOWN_ROUTES
    srv = server.InferenceServer(create_engine("test-llama-tiny", device="cpu"),
                                 "127.0.0.1", 0)
    srv.start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(base + "/debug/traces", timeout=30) as r:
            assert r.status == 200 and json.loads(r.read())["traces"] == []
        for path in ("/debug/traces/" + "ab" * 16, "/debug/traces/x?format=chrome"):
            with urllib.request.urlopen(base + path, timeout=30) as r:
                assert r.status == 200
        for path in ("/no/such/route", "/debug/nothing"):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(base + path, timeout=30)
            assert e.value.code == 404
    finally:
        srv.shutdown()
