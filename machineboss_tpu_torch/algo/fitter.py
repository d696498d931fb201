"""Baum-Welch EM fitter (ref: src/fitter.{h,cpp}).

Loop: evaluate machine -> expected counts (E) -> constrained optimize (M),
stopping at MaxEMIterations or relative improvement < MinEMImprovement.

The E-step runs either on host (exact float64, golden parity) or batched on
one device via ops/fwdback.py (parallel/em.py); set engine='device' for the
latter, with `device` naming where (None: the CUDA card, raising when CUDA
is absent; "cpu" for the CPU), and `mesh` for the data-parallel E-step
over a torch.distributed mesh's 'data' axis (parallel/mesh.py).
"""

from ..core.eval import EvaluatedMachine
from ..core.params import Params, Constraints
from .counts import MachineCounts, MachineObjective

MAX_EM_ITERATIONS = 1000
MIN_EM_IMPROVEMENT = 0.001


class MachineFitter:
    def __init__(self, machine=None, constraints=None, seed=None,
                 constants=None, engine="host", checkpoint_path=None,
                 mesh=None, device=None):
        self.machine = machine
        self.constraints = constraints if constraints is not None else Constraints()
        self.seed = seed if seed is not None else Params()
        self.constants = constants if constants is not None else Params()
        self.engine = engine
        # engine='device' + mesh: the E-step is sharded over the mesh's
        # 'data' axis (parallel/em.sharded_counts_fn); the full EM loop
        # then runs on every rank, whose counts are summed and replicated,
        # so every rank optimizes identical objectives
        self.mesh = mesh
        # engine='device': where the E-step runs
        self.device = device
        # EM checkpoint/resume: params + iteration + loglike are written
        # every iteration and restored on restart (the reference's de-facto
        # checkpoint is re-seeding from an emitted params JSON; this makes
        # it automatic)
        self.checkpoint_path = checkpoint_path

    def all_constraints(self):
        return self.machine.cons.combine(self.constraints)

    def _load_checkpoint(self):
        import json as _json
        import os
        if not self.checkpoint_path or not os.path.exists(
                self.checkpoint_path):
            return None
        with open(self.checkpoint_path) as f:
            ck = _json.load(f)
        from ..core.params import param_assign_from_json
        return (ck["iteration"], param_assign_from_json(ck["params"]),
                ck.get("loglike"))

    def _save_checkpoint(self, iteration, params, loglike):
        import json as _json
        if not self.checkpoint_path:
            return
        tmp = self.checkpoint_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(_json.dumps({
                "iteration": iteration,
                "loglike": loglike,
                "params": _json.loads(params.to_json_str()),
            }))
        import os
        os.replace(tmp, self.checkpoint_path)

    def fit(self, training_set, envelopes=None, width=None,
            max_iterations=MAX_EM_ITERATIONS):
        """max_iterations caps the EM loop (default = the reference's
        MaxEMIterations, ref src/fitter.cpp:6); with checkpoint_path set,
        a capped (or killed) fit resumes exactly where it stopped."""
        if envelopes is None:
            envelopes = training_set.envelopes(width)
        if len(envelopes) != len(training_set.seq_pairs):
            raise ValueError("Envelope/training set mismatch")
        params = self.seed
        prev = None
        start_iter = 0
        resumed = self._load_checkpoint()
        if resumed is not None:
            start_iter, params, prev = resumed
        for it in range(start_iter, max_iterations + 1):
            all_params = self.machine.funcs.combine(self.constants) \
                                           .combine(params)
            counts = self._estep(all_params, training_set, envelopes)
            if it > 0:
                if it == max_iterations:
                    break
                improvement = (counts.loglike - prev) / abs(prev)
                if improvement < MIN_EM_IMPROVEMENT:
                    break
            objective = MachineObjective(self.machine, counts,
                                         self.constraints, self.constants)
            params = objective.optimize(params)
            prev = counts.loglike
            self._save_checkpoint(it + 1, params, prev)
        return params

    def _estep(self, all_params, training_set, envelopes):
        if self.engine == "device":
            from ..parallel.em import device_counts
            return device_counts(self.machine, all_params, training_set,
                                 envelopes, mesh=self.mesh,
                                 device=self.device)
        ev = EvaluatedMachine(self.machine, all_params)
        return MachineCounts(ev, training_set, envelopes)
