"""``stego_torch.parallel.dist.launch``, which the entry points (``python
-m stego_torch.train``, ``.eval``, ``.train.knn_app``) start their ranks
with: on 2 CPU processes over gloo, by spawning them itself and by
joining the group of ``torch.distributed.run``'s environment."""

import os
import subprocess
import sys

from tests.test_torch_ddp import REPO, WORLD, free_port
from tests._torch_cpu import child_env, one_intra_op_thread  # noqa: F401

LAUNCH = ("import sys; from stego_torch.parallel import dist; "
          "from tests._torch_ddp_worker import record_rank; "
          "dist.launch(record_rank, int(sys.argv[1]), sys.argv[2], "
          "device='cpu')")


def test_launch_spawns_ranks_or_joins_a_launchers_group(tmp_path):
    """dist.launch with num_devices=2 and no launcher spawns 2 ranks; under
    torch.distributed.run's environment (WORLD_SIZE, RANK, MASTER_ADDR,
    MASTER_PORT) each process joins that group. Both on gloo and the CPU,
    as asked; every rank sees the other in an all_reduce."""
    env = {k: v for k, v in child_env().items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    spawned, joined = tmp_path / "spawned", tmp_path / "joined"
    spawned.mkdir()
    joined.mkdir()
    procs = [subprocess.Popen([sys.executable, "-c", LAUNCH, "2",
                               str(spawned)], cwd=REPO, env=env)]
    port = free_port()
    procs += [subprocess.Popen(
        [sys.executable, "-c", LAUNCH, "0", str(joined)], cwd=REPO,
        env=dict(env, WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r),
                 MASTER_ADDR="localhost", MASTER_PORT=str(port)))
        for r in range(WORLD)]
    try:
        codes = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert codes == [0] * 3
    for d in (spawned, joined):
        assert sorted(os.listdir(d)) == ["0_of_2", "1_of_2"]
        assert {(d / f).read_text() for f in os.listdir(d)} == {"3"}
