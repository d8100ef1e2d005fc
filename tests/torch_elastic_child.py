"""A worker of the port's elastic chaos test
(``test_torch_elastic.py::test_elastic_chaos_sigkill_one_of_three``) and
of the same scenario run by hand.

Each worker imports the port only, joins the task master's membership,
trains the small regressor over a generation-fenced
ElasticDataDispatcher reader through an ElasticTrainerLoop on the CPU,
and checkpoints every step. A worker launched with ``kill_at_step > 0``
arms ``worker_kill`` and SIGKILLs itself mid-pass; the survivors detect
the death through the heartbeat deadline, rebuild at G+1, restore their
newest intact checkpoint and finish the pass.

argv: repo master_port ds_glob ckpt_dir out_json worker_idx
      kill_at_step [n_workers]
"""

import json
import sys
import time

repo = sys.argv[1]
sys.path.insert(0, repo)

import numpy as np  # noqa: E402

from paddle_tpu_torch import core, layers, optimizer  # noqa: E402
from paddle_tpu_torch.data_feeder import DataFeeder  # noqa: E402
from paddle_tpu_torch.distributed import (ElasticDataDispatcher,  # noqa: E402
                                          ElasticTrainerLoop)
from paddle_tpu_torch.resilience import (RecoveryPolicy,  # noqa: E402
                                         ResilientTrainer, faults)
from paddle_tpu_torch.trainer import EndIteration  # noqa: E402

master_port, ds_glob, ckpt_dir, out_json = (int(sys.argv[2]), sys.argv[3],
                                            sys.argv[4], sys.argv[5])
worker_idx, kill_at_step = int(sys.argv[6]), int(sys.argv[7])
n_workers = int(sys.argv[8]) if len(sys.argv) > 8 else 1
WID = "w%d" % worker_idx
losses = []

if kill_at_step:
    faults.arm("worker_kill", at=kill_at_step, action="kill")


def build(world):
    main, startup = core.Program(), core.Program()
    with core.unique_name.guard(), core.program_guard(main, startup):
        xv = layers.data("x", shape=[4])
        yv = layers.data("y", shape=[1])
        pred = layers.fc(layers.fc(xv, 8, act="relu"), 1)
        loss = layers.mean(layers.square_error_cost(pred, yv))
        optimizer.SGD(learning_rate=0.05).minimize(loss, startup)
    trainer = ResilientTrainer(
        loss, feeder=DataFeeder([xv, yv]), main_program=main,
        startup_program=startup, checkpoint_dir=ckpt_dir,
        checkpoint_every_n_steps=1, device="cpu",
        policy=RecoveryPolicy(step_deadline_sec=30))
    disp = ElasticDataDispatcher(world.client, ds_glob, worker_id=WID,
                                 generation=world.generation)

    def reader():
        batch = []
        for s in disp.reader(poll_interval=0.1)():
            batch.append((np.asarray(s[1], "float32"),
                          np.asarray(s[2], "float32")))
            time.sleep(0.03)  # keep the pass longer than the detection
            if len(batch) == 8:
                yield batch
                batch = []
        if batch:
            yield batch
    return trainer, reader


def handler(e):
    if isinstance(e, EndIteration):
        losses.append(float(np.asarray(e.cost)))


loop = ElasticTrainerLoop(build, master_port, worker_id=WID,
                          heartbeat_interval_sec=0.2,
                          min_workers=n_workers)
with core.scope_guard(core.Scope()):
    result = loop.run(num_passes=1, event_handler=handler)
with open(out_json, "w") as f:
    json.dump({"worker": WID, "generations": loop.generations,
               "restarts": loop.restarts, "losses": losses,
               "result": result}, f)
print("DONE %s gens=%s restarts=%d" % (WID, loop.generations,
                                       loop.restarts), flush=True)
