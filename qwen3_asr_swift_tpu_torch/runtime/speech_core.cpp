/* speech_core — engine implementation. See speech_core.h for the contract.
 *
 * Threading model: callers push audio/text from any thread into a lock-
 * protected inbox; one engine thread runs the VAD loop, drives the state
 * machine, and invokes the model callbacks (so slow STT/LLM/TTS never
 * block the audio producer). Barge-in: between emitted TTS chunks the
 * speaking loop itself drains the inbox through VAD — a speech onset
 * there raises the interrupt flag and the drained audio lands in the
 * pre-speech ring so the interrupting utterance's start is preserved.
 * (Barge-in applies while SPEAKING — the audible phase; audio pushed
 * during THINKING queues and is evaluated as soon as speaking starts.)
 */

#include "speech_core.h"

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

double now_s() {
    return std::chrono::duration<double>(Clock::now().time_since_epoch()).count();
}

struct Tool {
    std::string name;
    std::string description;
    double last_called_s = -1e18;
};

}  // namespace

struct sc_pipeline {
    sc_config_t cfg;
    sc_callbacks_t cb;
    sc_event_fn event_fn;
    void *event_user;

    std::mutex mu;
    std::condition_variable cv;
    std::deque<float> inbox;             // raw pushed samples
    std::deque<std::string> text_inbox;  // injected text turns
    std::atomic<bool> stop_requested{false};
    bool resume_requested = false;
    std::atomic<bool> running{false};
    std::atomic<int> state{SC_STATE_IDLE};
    std::atomic<bool> interrupt{false};

    std::vector<Tool> tools;

    std::thread worker;

    // engine-local buffers
    std::vector<float> pre_speech;   // ring of recent audio while listening
    std::vector<float> utterance;    // accumulated speech segment

    void emit(sc_event_type_t type, const char *text = nullptr, const char *aux = nullptr,
              const int16_t *pcm = nullptr, size_t pcm_len = 0) {
        if (!event_fn) return;
        sc_event_t ev;
        ev.type = type;
        ev.state = state.load();
        ev.text = text;
        ev.aux = aux;
        ev.pcm = pcm;
        ev.pcm_len = pcm_len;
        event_fn(&ev, event_user);
    }

    void set_state(sc_state_t s) {
        if (state.exchange(s) != s) emit(SC_EVENT_STATE_CHANGED);
    }

    bool pop_chunk(std::vector<float> &chunk) {
        chunk.clear();
        std::unique_lock<std::mutex> lock(mu);
        cv.wait(lock, [&] {
            return stop_requested.load() || resume_requested || !text_inbox.empty() ||
                   inbox.size() >= static_cast<size_t>(cfg.vad_chunk);
        });
        if (stop_requested.load()) return false;
        if (!text_inbox.empty() || resume_requested) return true;  // caller re-loops
        chunk.assign(inbox.begin(), inbox.begin() + cfg.vad_chunk);
        inbox.erase(inbox.begin(), inbox.begin() + cfg.vad_chunk);
        return true;
    }

    bool take_text(std::string &text) {
        std::lock_guard<std::mutex> lock(mu);
        if (text_inbox.empty()) return false;
        text = std::move(text_inbox.front());
        text_inbox.pop_front();
        return true;
    }

    void trim_pre_speech() {
        size_t cap = static_cast<size_t>(cfg.pre_speech_s * cfg.sample_rate);
        if (pre_speech.size() > cap)
            pre_speech.erase(pre_speech.begin(),
                             pre_speech.begin() + (pre_speech.size() - cap));
    }

    void keep_pre_speech(const std::vector<float> &chunk) {
        pre_speech.insert(pre_speech.end(), chunk.begin(), chunk.end());
        trim_pre_speech();
    }

    // Drain whole VAD chunks from the inbox while speaking: onset there is
    // a barge-in. Drained audio joins the pre-speech ring so the start of
    // the interrupting utterance survives into the next turn.
    bool barge_in_pending() {
        if (!cfg.allow_interruption || !cb.vad_process) return false;
        std::vector<float> c;
        while (true) {
            {
                std::lock_guard<std::mutex> lock(mu);
                if (inbox.size() < static_cast<size_t>(cfg.vad_chunk)) break;
                c.assign(inbox.begin(), inbox.begin() + cfg.vad_chunk);
                inbox.erase(inbox.begin(), inbox.begin() + cfg.vad_chunk);
            }
            float prob = cb.vad_process(c.data(), c.size(), cb.user);
            keep_pre_speech(c);
            if (prob >= cfg.vad_onset) {
                interrupt.store(true);
                return true;
            }
        }
        return false;
    }

    std::string transcribe(const std::vector<float> &audio) {
        if (!cb.stt_transcribe || audio.empty()) return "";
        set_state(SC_STATE_TRANSCRIBING);
        char *res = cb.stt_transcribe(audio.data(), audio.size(), cb.user);
        std::string out = res ? res : "";
        std::free(res);
        return out;
    }

    // Returns false if interrupted mid-speech.
    bool speak(const std::string &text) {
        if (!cb.tts_synthesize || text.empty()) return true;
        set_state(SC_STATE_SPEAKING);
        int16_t *pcm = nullptr;
        size_t n = 0;
        if (cb.tts_synthesize(text.c_str(), &pcm, &n, cb.user) != 0 || !pcm) {
            emit(SC_EVENT_ERROR, nullptr, "tts failed");
            return true;
        }
        size_t step = static_cast<size_t>(cfg.speak_chunk);
        bool completed = true;
        for (size_t off = 0; off < n; off += step) {
            if (stop_requested.load()) {  // host stop aborts emission
                completed = false;
                break;
            }
            if (interrupt.load() || barge_in_pending()) {
                emit(SC_EVENT_INTERRUPTED);
                completed = false;
                break;
            }
            size_t len = std::min(step, n - off);
            emit(SC_EVENT_AUDIO_CHUNK, nullptr, nullptr, pcm + off, len);
        }
        std::free(pcm);
        return completed;
    }

    void handle_turn(const std::string &user_text) {
        if (user_text.empty()) {
            set_state(SC_STATE_LISTENING);
            return;
        }
        emit(SC_EVENT_FINAL_TRANSCRIPT, user_text.c_str());
        set_state(SC_STATE_THINKING);
        std::string response;
        if (cb.llm_respond) {
            char *res = cb.llm_respond(user_text.c_str(), cb.user);
            response = res ? res : "";
            std::free(res);
        } else {
            response = user_text;  // echo mode
        }

        // Tool-call convention: "\x01TOOL\x01name\x01args"
        if (response.rfind("\x01TOOL\x01", 0) == 0) {
            std::string rest = response.substr(6);
            size_t sep = rest.find('\x01');
            std::string name = rest.substr(0, sep);
            std::string args = sep == std::string::npos ? "" : rest.substr(sep + 1);
            bool allowed = false;
            {
                std::lock_guard<std::mutex> lock(mu);
                for (auto &tool : tools) {
                    if (tool.name == name) {
                        double t = now_s();
                        if (t - tool.last_called_s >= cfg.tool_cooldown_s) {
                            tool.last_called_s = t;
                            allowed = true;
                        }
                        break;
                    }
                }
            }
            if (allowed) {
                emit(SC_EVENT_TOOL_CALL, name.c_str(), args.c_str());
            } else {
                emit(SC_EVENT_ERROR, name.c_str(), "unknown tool or cooldown active");
            }
            set_state(SC_STATE_LISTENING);
            return;
        }

        emit(SC_EVENT_RESPONSE_TEXT, response.c_str());
        if (!stop_requested.load()) interrupt.store(false);
        bool completed = speak(response);
        if (completed) {
            set_state(SC_STATE_LISTENING);
        } else {
            // barge-in: drop straight back to listening; caller audio
            // already queues in the inbox
            interrupt.store(false);
            set_state(SC_STATE_LISTENING);
        }
    }

    void run() {
        set_state(SC_STATE_LISTENING);
        enum { SILENCE, PENDING_SPEECH, SPEECH, PENDING_SILENCE } vstate = SILENCE;
        double speech_started = 0, silence_started = 0, t = 0;
        const double chunk_s = static_cast<double>(cfg.vad_chunk) / cfg.sample_rate;
        std::string eager_transcript;
        std::vector<float> chunk;

        while (true) {
            {
                std::lock_guard<std::mutex> lock(mu);
                if (stop_requested) break;
                if (resume_requested) {
                    resume_requested = false;
                    if (state.load() != SC_STATE_LISTENING) set_state(SC_STATE_LISTENING);
                }
            }
            std::string text;
            if (take_text(text)) {
                handle_turn(text);
                continue;
            }
            if (!pop_chunk(chunk)) break;
            if (chunk.empty()) continue;  // woke for text

            float prob = cb.vad_process
                             ? cb.vad_process(chunk.data(), chunk.size(), cb.user)
                             : 0.0f;
            t += chunk_s;

            switch (vstate) {
                case SILENCE:
                    keep_pre_speech(chunk);
                    if (prob >= cfg.vad_onset) {
                        vstate = PENDING_SPEECH;
                        speech_started = t - chunk_s;
                        // pre_speech already ends with this chunk
                        utterance = pre_speech;
                    }
                    break;
                case PENDING_SPEECH:
                    utterance.insert(utterance.end(), chunk.begin(), chunk.end());
                    if (prob < cfg.vad_offset) {
                        vstate = SILENCE;
                        // a too-short burst is not a turn, but its audio
                        // must stay in the pre-roll or the next onset's
                        // pre-speech window has a hole in it
                        pre_speech = std::move(utterance);
                        trim_pre_speech();
                        utterance.clear();
                    } else if (t - speech_started >= cfg.min_speech_s) {
                        vstate = SPEECH;
                        emit(SC_EVENT_SPEECH_STARTED);
                    }
                    break;
                case SPEECH:
                    utterance.insert(utterance.end(), chunk.begin(), chunk.end());
                    if (prob < cfg.vad_offset) {
                        vstate = PENDING_SILENCE;
                        silence_started = t - chunk_s;
                        if (cfg.eager_stt) {
                            eager_transcript = transcribe(utterance);
                            // surface the eager result as a partial while the
                            // silence window is still confirming the turn
                            if (!eager_transcript.empty())
                                emit(SC_EVENT_PARTIAL_TRANSCRIPT, eager_transcript.c_str());
                        }
                    } else if (t - speech_started >= cfg.max_utterance_s) {
                        emit(SC_EVENT_SPEECH_ENDED);
                        vstate = SILENCE;
                        handle_turn(transcribe(utterance));
                        utterance.clear();
                        pre_speech.clear();
                    }
                    break;
                case PENDING_SILENCE:
                    utterance.insert(utterance.end(), chunk.begin(), chunk.end());
                    if (prob >= cfg.vad_onset) {
                        vstate = SPEECH;
                        eager_transcript.clear();  // speech resumed — discard
                        set_state(SC_STATE_LISTENING);
                    } else if (t - silence_started >= cfg.min_silence_s) {
                        emit(SC_EVENT_SPEECH_ENDED);
                        vstate = SILENCE;
                        std::string final_text = cfg.eager_stt && !eager_transcript.empty()
                                                     ? eager_transcript
                                                     : transcribe(utterance);
                        eager_transcript.clear();
                        utterance.clear();
                        pre_speech.clear();
                        handle_turn(final_text);
                    }
                    break;
            }
        }
        set_state(SC_STATE_IDLE);
    }
};

extern "C" {

sc_config_t sc_config_default(void) {
    sc_config_t c;
    c.sample_rate = 16000;
    c.vad_chunk = 512;
    c.vad_onset = 0.5f;
    c.vad_offset = 0.35f;
    c.min_speech_s = 0.25f;
    c.min_silence_s = 0.6f;
    c.pre_speech_s = 0.5f;
    c.max_utterance_s = 30.0f;
    c.eager_stt = 1;
    c.allow_interruption = 1;
    c.tool_cooldown_s = 5.0f;
    c.speak_chunk = 4096;
    return c;
}

sc_pipeline_t *sc_pipeline_create(const sc_config_t *config, const sc_callbacks_t *callbacks,
                                  sc_event_fn event_fn, void *event_user) {
    if (!callbacks) return nullptr;
    auto *p = new sc_pipeline();
    p->cfg = config ? *config : sc_config_default();
    p->cb = *callbacks;
    p->event_fn = event_fn;
    p->event_user = event_user;
    return p;
}

void sc_pipeline_destroy(sc_pipeline_t *p) {
    if (!p) return;
    sc_pipeline_stop(p);
    delete p;
}

int sc_pipeline_start(sc_pipeline_t *p) {
    if (!p) return -1;
    // atomic claim: two racing start() calls cannot both spawn workers
    // (assigning over a joinable std::thread would std::terminate)
    if (p->running.exchange(true)) return -1;
    if (p->worker.joinable()) p->worker.join();  // reap a finished run
    {
        std::lock_guard<std::mutex> lock(p->mu);
        p->stop_requested.store(false);
        p->inbox.clear();
        p->text_inbox.clear();
    }
    p->worker = std::thread([p] {
        p->run();
        p->running.store(false);
    });
    return 0;
}

int sc_pipeline_stop(sc_pipeline_t *p) {
    if (!p) return -1;
    {
        std::lock_guard<std::mutex> lock(p->mu);
        p->stop_requested.store(true);
    }
    p->interrupt.store(true);
    p->cv.notify_all();
    // joining our own thread (stop() called from an event callback, which
    // runs on the engine thread) would throw through the C ABI and abort
    // the process — set the flags and let the run loop wind down instead
    if (p->worker.joinable() && std::this_thread::get_id() != p->worker.get_id())
        p->worker.join();
    if (std::this_thread::get_id() != p->worker.get_id())
        p->running.store(false);
    return 0;
}

int sc_pipeline_is_running(const sc_pipeline_t *p) { return p && p->running.load() ? 1 : 0; }
int sc_pipeline_state(const sc_pipeline_t *p) { return p ? p->state.load() : SC_STATE_IDLE; }

int sc_pipeline_push_audio(sc_pipeline_t *p, const float *samples, size_t n) {
    if (!p || !samples) return -1;
    {
        std::lock_guard<std::mutex> lock(p->mu);
        p->inbox.insert(p->inbox.end(), samples, samples + n);
    }
    p->cv.notify_all();
    return 0;
}

int sc_pipeline_push_text(sc_pipeline_t *p, const char *text) {
    if (!p || !text) return -1;
    {
        std::lock_guard<std::mutex> lock(p->mu);
        p->text_inbox.emplace_back(text);
    }
    p->cv.notify_all();
    return 0;
}

int sc_pipeline_resume_listening(sc_pipeline_t *p) {
    if (!p) return -1;
    {
        std::lock_guard<std::mutex> lock(p->mu);
        p->resume_requested = true;
    }
    p->interrupt.store(false);
    p->cv.notify_all();
    return 0;
}

int sc_pipeline_add_tool(sc_pipeline_t *p, const char *name, const char *description) {
    if (!p || !name) return -1;
    std::lock_guard<std::mutex> lock(p->mu);
    Tool t;
    t.name = name;
    t.description = description ? description : "";
    p->tools.push_back(std::move(t));
    return 0;
}

int sc_pipeline_clear_tools(sc_pipeline_t *p) {
    if (!p) return -1;
    std::lock_guard<std::mutex> lock(p->mu);
    p->tools.clear();
    return 0;
}

}  // extern "C"
