/* speech_core — real-time voice-agent pipeline engine.
 *
 * C++ re-design of the reference's CSpeechCore engine (shipped only as a
 * binary xcframework; C API surface reconstructed from its Swift consumer,
 * reference: Sources/SpeechCore/VoicePipeline.swift:191-370):
 * state machine idle/listening/transcribing/thinking/speaking, VAD-driven
 * turn detection with hysteresis, pre-speech ring buffer, eager STT,
 * barge-in interruption, tool calling with cooldowns, PCM16 event payloads.
 *
 * Models are injected as C callbacks (the Python host wraps JAX-backed
 * models via ctypes; any other host can plug native implementations).
 * All sc_pipeline_* calls are thread-safe; events fire on the engine
 * thread.
 */
#ifndef SPEECH_CORE_H
#define SPEECH_CORE_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct sc_pipeline sc_pipeline_t;

typedef enum {
    SC_STATE_IDLE = 0,
    SC_STATE_LISTENING = 1,
    SC_STATE_TRANSCRIBING = 2,
    SC_STATE_THINKING = 3,
    SC_STATE_SPEAKING = 4,
} sc_state_t;

typedef enum {
    SC_EVENT_STATE_CHANGED = 0,
    SC_EVENT_SPEECH_STARTED = 1,
    SC_EVENT_SPEECH_ENDED = 2,
    SC_EVENT_PARTIAL_TRANSCRIPT = 3,
    SC_EVENT_FINAL_TRANSCRIPT = 4,
    SC_EVENT_RESPONSE_TEXT = 5,
    SC_EVENT_AUDIO_CHUNK = 6,
    SC_EVENT_TOOL_CALL = 7,
    SC_EVENT_INTERRUPTED = 8,
    SC_EVENT_ERROR = 9,
} sc_event_type_t;

typedef struct {
    sc_event_type_t type;
    int state;             /* current sc_state_t */
    const char *text;      /* transcript / response / tool name; may be NULL */
    const char *aux;       /* tool args / error detail; may be NULL */
    const int16_t *pcm;    /* PCM16 payload for AUDIO_CHUNK; may be NULL */
    size_t pcm_len;        /* samples in pcm */
} sc_event_t;

typedef void (*sc_event_fn)(const sc_event_t *event, void *user);

/* Model callbacks. Strings returned by callbacks must be heap-allocated
 * with malloc(); the engine frees them with free(). tts_synthesize
 * allocates *out with malloc(); the engine frees it. */
typedef struct {
    /* speech probability in [0,1] for a chunk of `n` float samples */
    float (*vad_process)(const float *samples, size_t n, void *user);
    /* transcribe float audio → UTF-8 text (malloc'd) or NULL */
    char *(*stt_transcribe)(const float *samples, size_t n, void *user);
    /* respond to user text → UTF-8 text (malloc'd) or NULL.
     * Tool-call convention: return "\x01TOOL\x01<name>\x01<args>" */
    char *(*llm_respond)(const char *text, void *user);
    /* synthesize text → PCM16 buffer; returns 0 on success */
    int (*tts_synthesize)(const char *text, int16_t **out, size_t *out_len, void *user);
    void *user;
} sc_callbacks_t;

typedef struct {
    int sample_rate;          /* default 16000 */
    int vad_chunk;            /* samples per VAD step, default 512 */
    float vad_onset;          /* default 0.5 */
    float vad_offset;         /* default 0.35 */
    float min_speech_s;       /* default 0.25 */
    float min_silence_s;      /* default 0.6 — end-of-turn silence */
    float pre_speech_s;       /* pre-speech ring kept before onset, default 0.5 */
    float max_utterance_s;    /* force end-of-turn, default 30 */
    int eager_stt;            /* 1 = transcribe at silence onset (default 1) */
    int allow_interruption;   /* 1 = barge-in cancels speaking (default 1) */
    float tool_cooldown_s;    /* min seconds between calls of one tool, default 5 */
    int speak_chunk;          /* samples per AUDIO_CHUNK event, default 4096 */
} sc_config_t;

sc_config_t sc_config_default(void);

sc_pipeline_t *sc_pipeline_create(const sc_config_t *config,
                                  const sc_callbacks_t *callbacks,
                                  sc_event_fn event_fn, void *event_user);
void sc_pipeline_destroy(sc_pipeline_t *p);

int sc_pipeline_start(sc_pipeline_t *p);
int sc_pipeline_stop(sc_pipeline_t *p);
int sc_pipeline_is_running(const sc_pipeline_t *p);
int sc_pipeline_state(const sc_pipeline_t *p);

/* Feed microphone audio (float32 at config.sample_rate). Thread-safe. */
int sc_pipeline_push_audio(sc_pipeline_t *p, const float *samples, size_t n);
/* Inject a user text turn, bypassing STT. */
int sc_pipeline_push_text(sc_pipeline_t *p, const char *text);
/* Return to LISTENING (e.g. after the host finishes playback). */
int sc_pipeline_resume_listening(sc_pipeline_t *p);

int sc_pipeline_add_tool(sc_pipeline_t *p, const char *name, const char *description);
int sc_pipeline_clear_tools(sc_pipeline_t *p);

#ifdef __cplusplus
}
#endif

#endif /* SPEECH_CORE_H */
