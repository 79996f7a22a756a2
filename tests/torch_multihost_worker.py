"""One rank of the port's two-process mesh test (no jax): join a gloo group,
hash this rank's slice of an 8-message batch through ``identify_step`` on a
2-shard CPU mesh, check the digests against the Python oracle and print the
duplicate flags on an OK line.

    python tests/torch_multihost_worker.py <port> <rank> <world>

Rank 1's second message is a copy of rank 0's second; each rank's last
message is empty (padding: never a duplicate).
"""

import sys

import numpy as np


def main() -> None:
    port, rank, world = (int(a) for a in sys.argv[1:4])
    import torch

    from spacedrive_tpu_torch.objects.blake3_ref import blake3
    from spacedrive_tpu_torch.ops.blake3 import digests_to_hex, pack_messages
    from spacedrive_tpu_torch.parallel.mesh import identify_step, init_multihost, make_mesh

    rng = np.random.default_rng(7)
    msgs = [rng.integers(0, 256, int(rng.integers(1, 3000)), dtype=np.uint8).tobytes()
            for _ in range(8)]
    msgs[5] = msgs[1]
    msgs[3] = msgs[7] = b""
    mine = msgs[rank * 4 : rank * 4 + 4]
    init_multihost(f"localhost:{port}", world, rank, device="cpu")
    try:
        mesh = make_mesh(devices=["cpu"] * 2)
        assert mesh.processes == world
        words, lengths = pack_messages(mine, 4)
        digests, dup = identify_step(mesh)(words, lengths)
        assert digests_to_hex(digests) == [blake3(m).hex() for m in mine]
        print(f"MULTIHOST OK rank {rank} dup {dup.tolist()}", flush=True)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
