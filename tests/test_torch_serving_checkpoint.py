"""The port's server with `--checkpoint DIR` on the CPU, against the JAX
package's engine on the same weights.

The server's CLI runs in process (its HTTP server bound to a free
loopback port): a checkpoint store written by the JAX package's
save_params and an HF directory written by transformers' save_pretrained
each serve /generate greedy ids (spelled by an id tokenizer) equal to the
JAX engine's on the same weights; tokenizer files found in the directory
are loaded strictly (a broken one stops the start); a missing directory,
a directory that is neither kind and a bad --tokenizer path fail loudly;
a --dtype that conflicts with the store's is refused; a checkpoint with
no tokenizer warns that responses are byte-decoded."""

import json
import urllib.request

import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax  # noqa: E402

from distributed_llm_inference_tpu.config import EngineConfig as JaxEngineConfig  # noqa: E402
from distributed_llm_inference_tpu.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from distributed_llm_inference_tpu.models import api as JM  # noqa: E402
from distributed_llm_inference_tpu.models import checkpoint as JS  # noqa: E402
from distributed_llm_inference_tpu.models import convert as JV  # noqa: E402
from distributed_llm_inference_tpu.models.registry import get_model_config as jax_cfg  # noqa: E402
from distributed_llm_inference_tpu_torch.serving import server as TS  # noqa: E402
from distributed_llm_inference_tpu_torch.utils.tokenizer import ByteTokenizer  # noqa: E402

PROMPT = "the quick brown fox"
BODY = {"prompt": PROMPT, "max_tokens": 10, "greedy": True, "chat": False}


class IdTokenizer(ByteTokenizer):
    """The byte tokenizer, with a decode that spells every id."""

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids)


def _serve(monkeypatch, argv):
    """Run the port server's main(argv) in process; returns the started
    server (the caller shuts it down)."""
    built = {}

    class Srv(TS.InferenceServer):
        def __init__(self, engine, host, port, *a, **kw):
            super().__init__(engine, "127.0.0.1", 0, *a, **kw)
            built["srv"] = self

        def serve_forever(self):
            self.start()

    monkeypatch.setattr(TS, "InferenceServer", Srv)
    TS.main(argv + ["--device", "cpu", "--max-tokens-cap", "64"])
    return built["srv"]


def _generate(srv) -> list:
    """/generate's greedy ids: the served engine's byte tokenizer swapped
    for one whose decode spells every id (its encode is the same)."""
    srv.engine.tokenizer = IdTokenizer()
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/generate", data=json.dumps(BODY).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        out = json.loads(r.read())
    assert out["status"] == "success", out
    return [int(t) for t in out["response"].split()]


def _jax_ids(cfg, params) -> list:
    eng = JaxEngine(cfg, params=params, tokenizer=IdTokenizer(),
                    engine_cfg=JaxEngineConfig())
    r = eng.generate(PROMPT, max_tokens=10, greedy=True, chat=False)
    return [int(t) for t in r["response"].split()]


def test_serves_a_jax_written_store(tmp_path, monkeypatch, capsys):
    cfg = jax_cfg("test-llama-tiny", dtype="float32", eos_token_id=-1)
    params = JM.init_params(cfg, jax.random.PRNGKey(5))
    store = str(tmp_path / "store")
    JS.save_params(store, cfg, params)
    srv = _serve(monkeypatch, ["--checkpoint", store])
    try:
        assert srv.engine.cfg.dtype == "float32" and srv.engine.cfg.name == "test-llama-tiny"
        r = _generate(srv)
    finally:
        srv.shutdown()
    assert r == _jax_ids(cfg, params) and len(r) == 10
    assert "without a tokenizer" in capsys.readouterr().out


def test_serves_an_hf_directory(tmp_path, monkeypatch):
    """A gpt2 save_pretrained directory served at --dtype float32 (the
    default for an HF directory is bfloat16): the JAX engine's ids on the
    JAX converter's params."""
    hf_cfg = transformers.GPT2Config(vocab_size=256, n_embd=64, n_layer=2, n_head=4,
                                     n_positions=128, eos_token_id=255, bos_token_id=255)
    torch.manual_seed(0)
    m = transformers.GPT2LMHeadModel(hf_cfg).eval()
    d = str(tmp_path / "hf")
    m.save_pretrained(d, safe_serialization=True)
    srv = _serve(monkeypatch, ["--checkpoint", d, "--dtype", "float32"])
    try:
        assert srv.engine.cfg.arch == "gpt2" and srv.engine.cfg.dtype == "float32"
        r = _generate(srv)
    finally:
        srv.shutdown()
    jcfg, jparams = JV.load_hf_checkpoint(d, dtype="float32")
    assert r == _jax_ids(jcfg, jparams) and r
    srv = _serve(monkeypatch, ["--checkpoint", d])
    try:
        assert srv.engine.cfg.dtype == "bfloat16"
    finally:
        srv.shutdown()


def test_tokenizer_files_in_the_directory_load_strictly(tmp_path, monkeypatch):
    """A word-level tokenizer saved beside the store is the one the server
    serves with; a broken tokenizer.json stops the start."""
    tokenizers = pytest.importorskip("tokenizers")
    cfg = jax_cfg("test-llama-tiny", dtype="float32", eos_token_id=-1)
    store = tmp_path / "store"
    JS.save_params(str(store), cfg, JM.init_params(cfg, jax.random.PRNGKey(0)))
    vocab = {w: i for i, w in enumerate(["<unk>", "<s>", "</s>", "the", "quick", "brown",
                                         "fox"])}
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, unk_token="<unk>", bos_token="<s>", eos_token="</s>",
    ).save_pretrained(str(store))
    srv = _serve(monkeypatch, ["--checkpoint", str(store)])
    try:
        assert not isinstance(srv.engine.tokenizer, ByteTokenizer)
        assert srv.engine.tokenizer.encode("the fox", add_bos=False) == [3, 6]
    finally:
        srv.shutdown()
    (store / "tokenizer.json").write_text("not json")
    with pytest.raises(Exception):
        _serve(monkeypatch, ["--checkpoint", str(store)])


def test_bad_directories_and_paths_fail_loudly(tmp_path, monkeypatch):
    cfg = jax_cfg("test-llama-tiny", dtype="float32")
    store = str(tmp_path / "store")
    JS.save_params(store, cfg, JM.init_params(cfg, jax.random.PRNGKey(0)))
    (tmp_path / "empty").mkdir()
    for d in (tmp_path / "nothing_here", tmp_path / "empty"):
        with pytest.raises(SystemExit, match="neither a local store"):
            _serve(monkeypatch, ["--checkpoint", str(d)])
    with pytest.raises(SystemExit, match="conflicts with the checkpoint's recorded dtype"):
        _serve(monkeypatch, ["--checkpoint", store, "--dtype", "bfloat16"])
    with pytest.raises(Exception):
        _serve(monkeypatch, ["--checkpoint", store, "--tokenizer", str(tmp_path / "nope")])
    # an HF directory whose config.json lacks a required key
    bad = tmp_path / "bad_hf"
    bad.mkdir()
    (bad / "config.json").write_text(json.dumps({"model_type": "llama"}))
    with pytest.raises(AttributeError, match="config.json has no"):
        _serve(monkeypatch, ["--checkpoint", str(bad)])
