"""Seconds of the hierarchy's build: ``setup_fn.seconds`` of
``setup_planes.make_kcycle_setup_planes``, the device synchronised at
both ends."""


def read(facts: dict):
    return facts["hierarchy_build_s"]
