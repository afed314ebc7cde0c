"""Bytes a VSN switch writes: the key map and instance set
(``elastic.vsn_switch_bytes``), where the window switched."""


def read(run):
    return float(run.switch_bytes) if run.switches else None
