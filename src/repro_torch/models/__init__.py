"""Model zoo of the serving and training paths: dense GQA attention,
RWKV6, MoE and hybrid attention+SSM blocks.

Held against ``src/repro/models`` (``config``, ``layers``, ``attention``,
``rwkv``, ``moe``, ``ssm``, ``transformer``, ``model``, ``scan_utils``);
``convert`` carries the reference's parameter trees, optimizer states
and caches across, both ways.  Sharding is not ported yet (ROADMAP.md
queue 1 item 10).
"""
