"""The port's CLI flags that the JAX package's CLIs take, on the CPU at
the tiny preset."""

import os

import numpy as np
import torch

from ishapediting_tpu_torch.cli import generate as tgen

torch.set_num_threads(2)


def test_generate_sharded_decode_equals_plain_run(tmp_path):
    """``--sharded_decode`` on one device decodes one grid at a time, as the
    JAX package does when it has one usable device
    (``ishapediting_tpu/cli/generate.py``: ``if args.sharded_decode and
    usable > 1``): the triplanes and the meshes equal a run without it,
    byte for byte."""
    common = ["--random_init", "--preset", "tiny", "--use_ddim", "--num_steps", "3",
              "--num_samples", "3", "--batch_size", "2", "--shape_resolution", "16",
              "--seed", "4", "--device", "cpu"]
    plain, sharded = tmp_path / "plain", tmp_path / "sharded"
    tgen.main(common + ["--save_dir", str(plain)])
    tgen.main(common + ["--sharded_decode", "--save_dir", str(sharded)])
    for i in range(3):
        np.testing.assert_array_equal(np.load(sharded / "triplanes" / f"{i}.npy"),
                                      np.load(plain / "triplanes" / f"{i}.npy"))
        obj = f"objects/{i}.obj"
        assert os.path.getsize(plain / obj) > 0
        assert (sharded / obj).read_bytes() == (plain / obj).read_bytes()
