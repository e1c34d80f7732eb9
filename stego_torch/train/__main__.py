"""``python -m stego_torch.train key=value ...``: the port's counterpart of
``train_segmentation.py`` (``config=<yaml>`` loads a base config; see
:func:`stego_torch.train.app.main`)."""

from stego_torch.train.app import main

if __name__ == "__main__":
    main()
