"""The eval CLI (counterpart of test.py; reference test.py):

    python -m mst_tpu_torch.test --config_filename <yaml> [flags]

Restores a whole checkpoint or a base + delta pair and runs the
multi-round stochastic test; mst_tpu's flags plus --device (cuda, which
must exist, or cpu).
"""

import time

from mst_tpu_torch import config as config_lib
from mst_tpu_torch import resolve_device
from mst_tpu_torch.data.splits import prepare_dataset
from mst_tpu_torch.train.trainer import restore_model
from mst_tpu_torch.utils.seeding import set_random_seeds


def main(args):
    tic = time.time()
    resolve_device(args.device)
    set_random_seeds(args.seed)
    params = config_lib.get_params(args=args)
    image_path, data_path = config_lib.get_image_and_data_path(params)

    _, _, test = prepare_dataset(
        data_path, args.load_data, args.batch_size, None, None,
        args.val_files, args.val_split, args.test_splits, args.shuffle,
        args.share_val_test, "eval", args.show_details)

    ckpts, ckpts_name, is_sep = config_lib.get_ckpts_and_names(
        args.ckpts, args.ckpts_name, args.pretrained_ckpt,
        [args.tuned_ckpt] if args.tuned_ckpt else [])
    print(ckpts, ckpts_name)

    # the reference's selection (test.py:31-40): with several checkpoints
    # only the LAST non-OODG one is tested; an all-OODG list leaves no
    # model, as in the reference
    model = None
    if len(ckpts_name) == 1:
        model = restore_model(params, is_sep[0], ckpts[0], None)
    else:
        for i, (ckpt, name) in enumerate(zip(ckpts, ckpts_name)):
            if name != "OODG":
                model = restore_model(params, is_sep[i],
                                      ckpt if not is_sep[i] else ckpts[0],
                                      None if not is_sep[i] else ckpt)

    print("############ Test model ##############")
    set_random_seeds(args.seed)
    model.test(test, image_path)

    toc = time.time()
    print("Time spent:", time.strftime("%Hh%Mm%Ss", time.gmtime(toc - tic)))


if __name__ == "__main__":
    main(config_lib.get_parser(False).parse_args())
