"""Third-person narrator demo with the PyTorch port.

Counterpart of ``cli/demo_narrator_3rd_person.py``: the reference's
demo_narrator_3rd_person.py differs from demo_narrator.py only in its
default model, checkpoint and crop convention, so this is the port's
``demo_narrator`` with the JAX script's default model (the MINI
narrator) and ``third_person`` set, as the JAX script sets it; neither
demo reads the flag.

    python -m lavila_tpu_torch.cli.demo_narrator_3rd_person --device cpu
"""

from lavila_tpu_torch.cli.demo_narrator import get_args_parser, main


def get_args():
    p = get_args_parser()
    p.set_defaults(third_person=True,
                   model="VCLM_OPENAI_TIMESFORMER_MINI_GPT2_MINI")
    return p


if __name__ == "__main__":
    main(get_args().parse_args())
