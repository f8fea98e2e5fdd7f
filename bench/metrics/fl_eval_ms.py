"""``fl_eval_ms``: milliseconds of a round's eval (PM, TM and GM accuracy
and the train loss), the engine's ``FLResult.part_seconds["eval"]`` of a
run timed by parts (``time_parts``, synchronized around each part), the
mean over its rounds."""


def read(t):
    evals = t.extras.get("parts", {}).get("eval")
    if not evals:
        return None
    return 1e3 * sum(evals) / len(evals)
