"""Batched LM serving with continuous batching (weight-stationary
deployment), on the port.

Thin front end over ``repro_torch.launch.serve``'s ``SlotServer``: submits
requests with different prompt lengths and reports throughput and latency.
Full width on the card by default (Qwen3-14B, bf16, random weights);
``--smoke`` takes the reduced configuration::

    python -m repro_torch.examples.serve_lm --arch qwen3-14b --requests 8
    python -m repro_torch.examples.serve_lm --smoke --device cpu
"""
import argparse

from ..launch.serve import main as serve_main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--arch', default='qwen3-14b')
    ap.add_argument('--requests', type=int, default=8)
    ap.add_argument('--slots', type=int, default=4)
    ap.add_argument('--max-new', type=int, default=8)
    ap.add_argument('--device', default='cuda',
                    help='torch device (cuda, cpu)')
    ap.add_argument('--smoke', action='store_true',
                    help='the reduced configuration')
    a = ap.parse_args(argv)
    return serve_main(['--arch', a.arch, '--requests', str(a.requests),
                       '--slots', str(a.slots), '--max-new', str(a.max_new),
                       '--device', a.device] + (['--smoke'] if a.smoke
                                                else []))


if __name__ == '__main__':
    main()
