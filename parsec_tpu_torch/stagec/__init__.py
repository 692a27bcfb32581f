"""stagec/ — whole-stage compilation: verified PTG stages as CUDA graphs.

Lower verified PTG stages into recorded programs: the lowerability pass
(:mod:`.plan`) partitions the instantiated DAG into compilable stages
vs interpreted residue using the analysis/ verdicts; the lowering pass
(:mod:`.lower`) emits one stage function per stage, recorded as ONE
CUDA graph per stage signature and cached per spec/NB/dtype/stage
shape; sharded variants (:mod:`.sharded`) run wave fronts over the
rank's chip mesh; cross-pool chaining (:mod:`.chain`) records
sequentially composed pools' boundary stages into one program; and the
runtime integration (:mod:`.runtime`) executes compiled stages as
single chores interleaved with the interpreted residue behind the
``stage_compile`` MCA knob.  Cross-rank SPMD stages (:mod:`.xrank`,
``stage_compile_xrank``) run a wave front that spans the ranks of one
process as one program over their lane chips, its activations carrying
control only.
"""
from .plan import (ClassVerdict, Stage, StagePlan, class_verdicts,
                   lower_report, plan_stages, stage_report)
from .lower import StageLayout, build_layout, build_stage_fn, spec_token
from .runtime import StageCompiler, prepared_plan, try_install
from .chain import ChainState, boundary_verdict, declare_chain

__all__ = [
    "ClassVerdict", "Stage", "StagePlan", "class_verdicts",
    "lower_report", "plan_stages", "stage_report", "StageLayout",
    "build_layout", "build_stage_fn", "spec_token", "StageCompiler",
    "prepared_plan", "try_install", "ChainState", "boundary_verdict",
    "declare_chain",
]
