"""Seconds a round outside the training, fold, evaluation and checkpoint
phases: with checkpoints off, the message accounting.  The mean over the
window's untraced rounds."""


def read(rec):
    rounds = rec["rounds"]
    return sum(r["wall_s"] - r["train_s"] - r["eval_s"] - r["checkpoint_s"]
               for r in rounds) / len(rounds)
