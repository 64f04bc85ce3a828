"""The port's tools, run as `python -m ed25519_consensus_tpu_torch.tools.<name>`:
the kernel tools — the variant sweep (`kernel_lab`), the stage profile and
micro-probes (`microbench`), the register report (`ptxas_report`) — and the
service tools — the mempool→block→vote-replay lab (`replay_lab`) and the
overload soak (`load_soak`)."""
