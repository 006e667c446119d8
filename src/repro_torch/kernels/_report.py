"""Where a kernel wrapper reports its call: the
``launch.step_analysis.StepAnalysis`` that is counting, or None.

Each wrapper checks ``active`` once on entry; while it is None (no
analysis counting) a launch costs that one check and nothing else.
"""
active = None
