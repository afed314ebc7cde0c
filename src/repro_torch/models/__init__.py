"""Model zoo of the serving path: dense GQA attention and RWKV6 blocks.

Held against ``src/repro/models`` (``config``, ``layers``, ``attention``,
``rwkv``, ``moe``, ``ssm``, ``transformer``, ``model``); ``convert``
carries the reference's parameter trees and caches across.  Sharding and
training are not ported yet (ROADMAP.md).
"""
