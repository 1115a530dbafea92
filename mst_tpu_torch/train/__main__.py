"""The train CLI (counterpart of train.py; reference train.py):

    python -m mst_tpu_torch.train --config_filename <yaml> [flags]

mst_tpu's flags plus --device (cuda, which must exist, or cpu). The same
flow: seed, params, splits, experiment name, build or restore, the
optional --init_check, train, then test on the left-out data.

Data-parallel over N devices, one process each (rank r on cuda:LOCAL_RANK
unless --device cpu; only rank 0 prints):

    torchrun --nproc_per_node N -m mst_tpu_torch.train --mesh_shape N ...
    torchrun --nnodes R --nproc_per_node D ... --mesh_shape R D \\
        --mesh_axes replica data
"""

import time

from mst_tpu_torch import config as config_lib
from mst_tpu_torch import resolve_device
from mst_tpu_torch.data.splits import prepare_dataset
from mst_tpu_torch.parallel import mesh as mesh_lib
from mst_tpu_torch.train.trainer import Experiment
from mst_tpu_torch.utils.seeding import set_random_seeds


def main(args):
    tic = time.time()
    device = resolve_device(args.device)
    config_lib.check_loop_ported(vars(args))
    mesh = mesh_lib.mesh_from_shape(args.mesh_shape, args.mesh_axes, device)
    set_random_seeds(args.seed)
    params = config_lib.get_params(args=args)
    image_path, data_path = config_lib.get_image_and_data_path(params)

    train, val, test = prepare_dataset(
        data_path, args.load_data, args.batch_size, args.n_train_batch,
        args.train_files, args.val_files, args.val_split, args.test_splits,
        args.shuffle, args.share_val_test, "train", args.show_details)

    experiment_name = config_lib.get_experiment_name(
        args, train.meta_ids().shape[0])
    print(f"Experiment {experiment_name} has started")

    model = Experiment(params, mesh=mesh)
    if args.pretrained_ckpt is not None:
        model.load_params(args.pretrained_ckpt)
        print(f"Loaded checkpoint {args.pretrained_ckpt}")
    else:
        print("Training from scratch")

    if args.init_check:
        if args.pretrained_ckpt is None:
            raise ValueError(
                "--init_check compares an adapter-free twin of a PRETRAINED "
                "checkpoint (reference train.py:47-59); pass "
                "--pretrained_ckpt")
        # the adapter-free twin must score identically (train.py:47-59)
        pretrained = Experiment(dict(params, position=[]), mesh=mesh)
        pretrained.load_params(args.pretrained_ckpt)
        ade_pre, fde_pre, _, _ = pretrained.test(test, image_path)
        ade_cur, fde_cur, _, _ = model.test(test, image_path)
        if abs(ade_pre - ade_cur) > 1e-9 or abs(fde_pre - fde_cur) > 1e-9:
            raise RuntimeError("Wrong model initialization")
        print("Passed initialization check")

    print("############ Train model ##############")
    model.train(train, val, image_path, image_path, experiment_name)

    print("############ Test leftout data ##############")
    set_random_seeds(args.seed)
    model.test(test, image_path)

    toc = time.time()
    print("Time spent:", time.strftime("%Hh%Mm%Ss", time.gmtime(toc - tic)))


if __name__ == "__main__":
    with mesh_lib.rank_zero_prints():
        main(config_lib.get_parser(True).parse_args())
