"""plan_s (s), layer "planner": host clock around the mapping search
(``core.map_net`` / ``launch.transformer.transformer_mapping``, from the
mapping cache after a checkout's first run) and ``exec.compile_plan``."""


def read(run):
    return run.plan_s
