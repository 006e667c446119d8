"""Batched-serving example on the PyTorch port: greedy decoding of a
reduced config through ``serve_step`` (the counterpart of
``examples/serve_lm.py``, with the same assertion).  Runs on the CUDA
card, or on the CPU with ``--device cpu``:

  PYTHONPATH=src python examples/serve_lm_torch.py [--arch llama3.2-3b] \
      [--device cpu]
"""
import argparse
import json

from repro_torch.launch.serve import greedy_decode


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cpu, or cuda[:i]; default the CUDA card")
    args = ap.parse_args()
    out = greedy_decode(args.arch, reduced=True, batch=args.batch,
                        prompt_len=args.prompt_len,
                        gen_tokens=args.gen_tokens, device=args.device)
    print(json.dumps(out, indent=2))
    assert out["finite"]
    print("OK: served a batch with finite logits")


if __name__ == "__main__":
    main()
