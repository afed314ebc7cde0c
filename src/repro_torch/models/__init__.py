"""Model zoo of the serving path: dense GQA attention and RWKV6 blocks.

Held against ``src/repro/models`` (``config``, ``layers``, ``attention``,
``rwkv``, ``transformer``, ``model``); ``convert`` carries the reference's
parameter trees and caches across.  MoE, the SSM/hybrid blocks, sharding
and training are not ported yet (ROADMAP.md).
"""
