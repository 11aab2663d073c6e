"""One server process of the port's two-process mesh tests
(tests/test_torch_multihost.py): joins the processes' gloo group at the
coordinator (parallel/mesh.multihost_initialize), builds the pp = 2 engine
whose ranks span both processes from a checkpoint store (each process's
rank reads only its own shard), generates once (greedy, its ids spelled
by the tokenizer's decode) and prints one line, RESULT:{json}. Imports no
jax.

Usage: torch_multihost_worker.py <process_id> <coordinator_port> <store>
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    pid, port, store = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    import torch

    torch.set_num_threads(1)
    from distributed_llm_inference_tpu_torch.config import MeshConfig
    from distributed_llm_inference_tpu_torch.models.checkpoint import load_config
    from distributed_llm_inference_tpu_torch.parallel import mesh as PM
    from distributed_llm_inference_tpu_torch.runtime import create_engine
    from distributed_llm_inference_tpu_torch.utils.tokenizer import ByteTokenizer

    class IdTokenizer(ByteTokenizer):
        def decode(self, ids, skip_special_tokens=True):
            return " ".join(str(int(i)) for i in ids)

    PM.multihost_initialize(f"127.0.0.1:{port}", 2, pid)
    engine = create_engine(load_config(store), mesh_cfg=MeshConfig(pp=2), store=store,
                           tokenizer=IdTokenizer(), device="cpu")
    try:
        r = engine.generate("multi host hello", max_tokens=5, greedy=True, chat=False)
        stages = engine.workers()["workers"]
        print("RESULT:" + json.dumps({
            "pid": pid, "status": r["status"], "response": r.get("response"),
            "tokens": r.get("tokens_generated"),
            "stages": {k: v["status"] for k, v in sorted(stages.items())},
            "store_bytes": [x["store_shard_bytes"] for v in stages.values()
                            for x in v["ranks"] if "store_shard_bytes" in x],
        }), flush=True)
    finally:
        engine.backend.close()


if __name__ == "__main__":
    main()
