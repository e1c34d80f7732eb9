"""``python -m stego_torch.eval model_path=<.ckpt> ...``: evaluate
checkpoints over a dataset (the counterpart of ``eval_segmentation.py``)."""

from stego_torch.eval.evaluate import main

if __name__ == "__main__":
    main()
