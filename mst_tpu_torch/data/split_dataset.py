"""The random train/val/test splitter (counterpart of
mst_tpu/data/split_dataset.py; reference utils/split_dataset.py).

    python -m mst_tpu_torch.data.split_dataset --data_dir ... \
        --data_filename x.pkl [--val_split 0.1] [--test_split 0.2] [--seed 1]
"""

import argparse

from mst_tpu_torch.data.splits import split_train_val_test_randomly


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--data_filename", required=True)
    parser.add_argument("--val_split", default=0.1, type=float)
    parser.add_argument("--test_split", default=0.2, type=float)
    parser.add_argument("--seed", default=1, type=int)
    args = parser.parse_args(argv)
    split_train_val_test_randomly(args.data_dir, args.data_filename,
                                  args.val_split, args.test_split, args.seed)


if __name__ == "__main__":
    main()
