from mp2p_icp_tpu_torch.parallel.batch import crop_batched, make_batched_align, stack_pytrees  # noqa: F401
