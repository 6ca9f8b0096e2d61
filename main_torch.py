"""The PyTorch port's command line: ``python main_torch.py -m train -d <ds>
--model <name>``, with ``main.py``'s flags (see ``sl_hwgat_tpu_torch/cli.py``).
Runs on the card (``-c 0``, the default) unless given ``-c cpu``."""

from sl_hwgat_tpu_torch.cli import main

if __name__ == "__main__":
    main()
